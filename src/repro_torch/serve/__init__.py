"""Serving of the port: the batched engine on a ring or paged KV cache,
prefix sharing, chunked prefill and their straight-line oracles, plus the
HTTP/SSE server (``repro_torch.serve.server``) and the prefix-affinity
router (``repro_torch.serve.router``), both imported lazily;
``ReferenceEngine`` is the seed host-loop engine, the slow baseline."""
from repro_torch.serve.engine import (BatchedEngine, BlockAllocator,
                                      InvalidRequestError, ReferenceEngine,
                                      Request, RequestCancelledError,
                                      RequestTimeoutError)
from repro_torch.serve.prefix import (PrefixIndex, SharedBlockPool,
                                      chunked_reference_trajectory,
                                      prompt_digests, ring_reference_futures)

__all__ = ["BatchedEngine", "BlockAllocator", "InvalidRequestError",
           "PrefixIndex", "ReferenceEngine", "Request",
           "RequestCancelledError",
           "RequestTimeoutError", "SharedBlockPool",
           "chunked_reference_trajectory", "prompt_digests",
           "ring_reference_futures", "InferenceServer", "RouterServer",
           "ReplicaSupervisor", "PrefixAffinityScheduler"]

_LAZY = {
    "InferenceServer": "repro_torch.serve.server",
    "RouterServer": "repro_torch.serve.router",
    "ReplicaSupervisor": "repro_torch.serve.router",
    "PrefixAffinityScheduler": "repro_torch.serve.router",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is not None:
        import importlib
        return getattr(importlib.import_module(mod), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
