"""Counting a sharded step's collectives (the JAX package's
``launch/dryrun.py::collective_bytes``).

The reference reads the collectives out of XLA's partitioned HLO and sums
each one's per-device result bytes by kind.  The port's sharded step runs
eagerly on DTensors, whose redistributions issue functional collectives
(``torch.ops._c10d_functional``, and DTensor's own all-to-all
``torch.ops._dtensor.shard_dim_alltoall``): :class:`CollectiveCounter` is a
``TorchDispatchMode`` that sees each of them as it is dispatched and sums
the bytes of the tensor it returns on this rank, under the reference's
kind names.  It counts the same on a ``fake`` process group over meta
tensors (the dry run, nothing moved) as on a real group (the gloo tests
hold the two equal, kind by kind).

DTensor-level operations are passed on (``NotImplemented``), so the mode
sees what DTensor runs on each rank's local tensors: the collectives, and
for the dry run's counters (``launch.dryrun``) the local products and
traffic.  DTensor's sharding propagation runs each operation once more on
fake global tensors to learn its output's shape; those calls are not part
of the step and are not counted (:func:`in_shape_propagation`).

    with CollectiveCounter() as cc:
        step(*dtensor_args)
    cc.bytes      # {"all-reduce": 5510148, ...} per device
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# functional collectives by op name -> the reference's HLO kind names
KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "permute": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
               "c10d_functional", "_dtensor")


def collective_kind(func) -> str:
    """The reference's kind name of a functional collective, else ''."""
    if getattr(func, "namespace", None) not in _NAMESPACES:
        return ""
    return KINDS.get(func._schema.name.split("::")[-1], "")


def in_shape_propagation() -> bool:
    """True while DTensor's sharding propagation runs an operation on fake
    global tensors to learn its output's metadata (under a
    ``FakeTensorMode``): no work of the step."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def _tensor_bytes(out) -> int:
    return sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(out)
               if isinstance(t, torch.Tensor))


class CollectiveCounter(TorchDispatchMode):
    """Sums, per kind, the result bytes on this rank of every functional
    collective dispatched under it (``bytes``), and counts the calls
    (``calls``)."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, int] = {}
        self.calls: Dict[str, int] = {}

    @property
    def total(self) -> int:
        return sum(self.bytes.values())

    def record(self, func, out) -> None:
        kind = collective_kind(func)
        if kind:
            self.bytes[kind] = self.bytes.get(kind, 0) + _tensor_bytes(out)
            self.calls[kind] = self.calls.get(kind, 0) + 1

    def count(self, func, args, kwargs, out) -> None:
        """Account one local operation (subclasses count more)."""
        self.record(func, out)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is not torch.Tensor and issubclass(t, torch.Tensor)
               and not _is_fake(t) for t in types):
            # a DTensor (or a collective's async wrapper): its own dispatch
            # runs the local operations, which come back here
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not in_shape_propagation():
            self.count(func, args, kwargs, out)
        return out


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return issubclass(t, FakeTensor)
