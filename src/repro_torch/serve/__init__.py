"""Serving of the port: the batched engine on a ring or paged KV cache,
prefix sharing, chunked prefill and their straight-line oracles."""
from repro_torch.serve.engine import (BatchedEngine, BlockAllocator,
                                      InvalidRequestError, Request,
                                      RequestCancelledError,
                                      RequestTimeoutError)
from repro_torch.serve.prefix import (PrefixIndex, SharedBlockPool,
                                      chunked_reference_trajectory,
                                      ring_reference_futures)

__all__ = ["BatchedEngine", "BlockAllocator", "InvalidRequestError",
           "PrefixIndex", "Request", "RequestCancelledError",
           "RequestTimeoutError", "SharedBlockPool",
           "chunked_reference_trajectory", "ring_reference_futures"]
