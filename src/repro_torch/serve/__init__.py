"""Serving of the port: the batched engine on a ring or paged KV cache,
prefix sharing and its fork oracle."""
from repro_torch.serve.engine import (BatchedEngine, BlockAllocator,
                                      InvalidRequestError, Request,
                                      RequestCancelledError,
                                      RequestTimeoutError)
from repro_torch.serve.prefix import (PrefixIndex, SharedBlockPool,
                                      ring_reference_futures)

__all__ = ["BatchedEngine", "BlockAllocator", "InvalidRequestError",
           "PrefixIndex", "Request", "RequestCancelledError",
           "RequestTimeoutError", "SharedBlockPool",
           "ring_reference_futures"]
