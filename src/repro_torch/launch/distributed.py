"""Multi-process bootstrap (the JAX package's ``launch/distributed.py``).

Every process of a multi-card run calls :func:`ensure_distributed`, which
joins the ``torch.distributed`` process group from torchrun's environment
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; the reference
reads ``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``)
and checks the device count; ``launch.mesh.device_mesh`` then sees every
card.  In one process it is a no-op.  Nothing here finds a cluster: the
address comes from the environment or from ``coordinator``.

    from repro_torch.launch.distributed import ensure_distributed
    ensure_distributed(expect_devices=4)     # 4 cards, one process each
"""
from __future__ import annotations

import os
from typing import Optional


def global_device_count() -> int:
    """The process group's world size (one card a process), or in one
    process the cards it sees (1 without a card: the CPU)."""
    import torch
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def ensure_distributed(*, expect_devices: Optional[int] = None,
                       coordinator: Optional[str] = None) -> int:
    """Join the process group when launched multi-process (``WORLD_SIZE`` >
    1 with ``MASTER_ADDR``/``MASTER_PORT``, or ``coordinator`` as
    ``host:port``): NCCL on the card, gloo on the CPU.  Returns the global
    device count and raises ``RuntimeError`` where it is not
    ``expect_devices``.  Safe to call again, and a no-op in one process or
    where the group is already initialised."""
    import torch
    import torch.distributed as dist
    world = int(os.environ.get("WORLD_SIZE", "1"))
    addr = coordinator
    if addr is None and "MASTER_ADDR" in os.environ:
        addr = (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    if world > 1 and addr and not dist.is_initialized():
        dist.init_process_group(
            "nccl" if torch.cuda.is_available() else "gloo",
            init_method=f"tcp://{addr}", world_size=world,
            rank=int(os.environ.get("RANK", "0")))
    n = global_device_count()
    if expect_devices is not None and n != expect_devices:
        raise RuntimeError(
            f"expected {expect_devices} global devices, found {n}; "
            "check the slice topology / process env")
    return n
