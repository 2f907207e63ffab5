"""Structured error taxonomy for every inference surface.

One vocabulary of machine-readable error codes shared by the in-process
backends, the HTTP front-end (``repro_torch.serve.server``) and the wire client
(``repro_torch.api.RemoteBackend``): each :class:`ApiError` carries a stable
``code`` plus the HTTP status the server maps it to, and serializes to the
canonical JSON error body

    {"error": {"code": "<code>", "message": "<human text>"}}

so a validation failure raised by ``InferenceBackend._validate`` surfaces as
the *same exception type* whether the backend lives in-process or across the
network.  ``ApiError`` subclasses ``ValueError``, so every pre-existing
``pytest.raises(ValueError, ...)`` contract over the SDK/client keeps
holding.
"""
from __future__ import annotations

from typing import Dict, Optional, Type

__all__ = [
    "ApiError", "EmptyTrajectoryError", "TooLongError", "AgesRequiredError",
    "AgesLengthMismatchError", "RngNotSerializableError",
    "UnsupportedOverrideError", "InvalidRequestError", "ProtocolVersionError",
    "UnknownEndpointError", "RequestTimeoutError", "RequestCancelledError",
    "ReplicaUnavailableError", "InternalServerError", "error_from_code",
    "error_from_json",
]


class ApiError(ValueError):
    """Base of the taxonomy: a ``ValueError`` with a stable wire identity.

    ``code`` is the machine-readable contract (clients branch on it, tests
    assert it, the server maps it 1:1 to ``http_status``); ``message`` is
    human text and may change freely between releases.
    """
    code: str = "bad_request"
    http_status: int = 400

    # code -> subclass, filled by __init_subclass__: the single source of
    # truth for reconstructing typed errors from wire bodies
    registry: Dict[str, Type["ApiError"]] = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        ApiError.registry[cls.code] = cls

    def __init__(self, message: str, *, code: Optional[str] = None,
                 http_status: Optional[int] = None):
        super().__init__(message)
        if code is not None:
            self.code = code
        if http_status is not None:
            self.http_status = http_status

    @property
    def message(self) -> str:
        return str(self.args[0]) if self.args else ""

    def to_json(self) -> dict:
        """The canonical wire body (the server sends exactly this)."""
        return {"error": {"code": self.code, "message": self.message}}


# -- validation failures (InferenceBackend._validate) ------------------------
class EmptyTrajectoryError(ApiError):
    code = "empty_trajectory"


class TooLongError(ApiError):
    code = "too_long"


class AgesRequiredError(ApiError):
    code = "ages_required"


class AgesLengthMismatchError(ApiError):
    code = "ages_length_mismatch"


# -- request-construction / serialization failures ---------------------------
class RngNotSerializableError(ApiError):
    """``GenerateRequest.rng`` holds live host PRNG state — it cannot cross a
    process boundary; inject ``uniforms`` (or pass ``seed``) instead."""
    code = "rng_not_serializable"


class UnsupportedOverrideError(ApiError):
    """Per-request knob the serving backend compiled in at construction."""
    code = "unsupported_override"


class InvalidRequestError(ApiError):
    """Malformed body: not JSON, wrong types, or missing required fields."""
    code = "invalid_request"


class ProtocolVersionError(ApiError):
    """Client and server speak different wire-protocol versions."""
    code = "protocol_version_mismatch"
    http_status = 409


# -- server-side conditions ---------------------------------------------------
class UnknownEndpointError(ApiError):
    code = "unknown_endpoint"
    http_status = 404


class RequestTimeoutError(ApiError):
    code = "timeout"
    http_status = 504


class RequestCancelledError(ApiError):
    """The request was cancelled (``POST /v1/cancel`` / ``engine.cancel``)
    before it completed; any partial output was discarded server-side.  SSE
    streams signal this as a terminal ``cancelled`` frame."""
    code = "request_cancelled"
    http_status = 409


class ReplicaUnavailableError(ApiError):
    """The serving replica cannot be reached.  Raised client-side by
    ``RemoteBackend`` when the server is unreachable at the transport level
    (connect failure, connection dropped mid-response), and served by the
    multi-replica router (``repro_torch.serve.router``) when no healthy replica
    remains to take the request — including a retried idempotent call whose
    every candidate failed, and a pinned stream whose replica died
    mid-flight (terminal SSE ``error`` frame carrying this code)."""
    code = "replica_unavailable"
    http_status = 503


class InternalServerError(ApiError):
    code = "internal"
    http_status = 500


def error_from_code(code: str, message: str) -> ApiError:
    """Reconstruct the typed error for a wire ``code`` (unknown codes fall
    back to a plain ``ApiError`` carrying the code verbatim, so a newer
    server never crashes an older client)."""
    cls = ApiError.registry.get(code)
    if cls is None:
        return ApiError(message, code=code)
    return cls(message)


def error_from_json(body: dict) -> ApiError:
    """Inverse of :meth:`ApiError.to_json` (tolerates malformed bodies)."""
    err = body.get("error", {}) if isinstance(body, dict) else {}
    return error_from_code(str(err.get("code", "internal")),
                           str(err.get("message", "unknown server error")))
