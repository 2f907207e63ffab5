"""Serving of the port: the ring-cache batched engine."""
from repro_torch.serve.engine import (BatchedEngine, Request,
                                      RequestCancelledError,
                                      RequestTimeoutError)

__all__ = ["BatchedEngine", "Request", "RequestCancelledError",
           "RequestTimeoutError"]
