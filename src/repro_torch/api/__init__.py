"""Unified inference client API of the port.

``Client`` and three backends (engine and local in-process, plus
``RemoteBackend`` speaking the versioned JSON/SSE wire protocol against a
``repro_torch.serve.server``) over shared request/result schemas and one
structured error taxonomy.  See ``repro_torch.api.client``.
"""
from repro_torch.api.client import (Client, EngineBackend, InferenceBackend,
                                    LocalBackend)
from repro_torch.api.errors import (AgesLengthMismatchError,
                                    AgesRequiredError, ApiError,
                                    EmptyTrajectoryError,
                                    ProtocolVersionError,
                                    ReplicaUnavailableError,
                                    RequestCancelledError,
                                    RequestTimeoutError,
                                    RngNotSerializableError, TooLongError,
                                    error_from_code, error_from_json)
from repro_torch.api.remote import RemoteBackend
from repro_torch.api.schemas import (WIRE_PROTOCOL_VERSION, FuturesRequest,
                                     FuturesResult, GenerateRequest, RiskItem,
                                     RiskReport, TrajectoryEvent,
                                     TrajectoryResult)

__all__ = [
    "Client", "InferenceBackend",
    "EngineBackend", "LocalBackend", "RemoteBackend",
    "GenerateRequest", "TrajectoryEvent", "TrajectoryResult",
    "FuturesRequest", "FuturesResult",
    "RiskItem", "RiskReport", "WIRE_PROTOCOL_VERSION",
    "ApiError", "EmptyTrajectoryError", "TooLongError", "AgesRequiredError",
    "AgesLengthMismatchError", "RngNotSerializableError",
    "ProtocolVersionError", "RequestCancelledError", "RequestTimeoutError",
    "ReplicaUnavailableError", "error_from_code", "error_from_json",
]
