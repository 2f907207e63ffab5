"""Mesh descriptions of the port (the JAX package's ``launch/mesh.py``).

A :class:`Mesh` names its axes and their sizes and nothing else: the
sharding rules (``launch.sharding``), the input specs and the dry run read
only that, so a 16 x 16 or 2 x 16 x 16 production mesh is described
without 256 or 512 devices.  :func:`device_mesh` turns a description into
a ``torch.distributed`` ``DeviceMesh`` over the process group, and only
when the group's world size equals the mesh's size.

The axes are the reference's: the batch shards over ``("pod", "data")``,
heads, hidden widths, experts, Mamba channels and the vocabulary over
``"model"``.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Iterator, Tuple


@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, in order (the JAX ``Mesh``'s ``axis_names``
    and ``shape``)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as the JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of devices the mesh spans."""
        return math.prod(self.sizes)

    @property
    def name(self) -> str:
        """``"16x16"``, ``"2x16x16"``: the dry run's record key."""
        return "x".join(str(s) for s in self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 = 256 devices; ``multi_pod`` stacks 2 of them: 512."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh() -> Mesh:
    """One device (1 x 1) with the production axis names."""
    return Mesh(("data", "model"), (1, 1))


def data_axes(mesh) -> tuple:
    """Mesh axes that shard the batch dimension."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_axis_size(mesh) -> int:
    return mesh.shape.get("model", 1)


def device_mesh(mesh: Mesh, device_type: str = "cuda"):
    """The ``torch.distributed.device_mesh.DeviceMesh`` of ``mesh`` over
    the initialised process group, with the mesh's axis names as its
    dimension names.  Raises ``RuntimeError`` when no process group is
    initialised or its world size is not the mesh's size (a mesh larger
    than the group cannot be placed; the dry run describes such meshes
    without one)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"device_mesh({mesh.name}) needs an initialised "
                           f"process group (launch.distributed."
                           f"ensure_distributed)")
    world = dist.get_world_size()
    if world != mesh.size:
        raise RuntimeError(f"mesh {mesh.name} spans {mesh.size} devices, "
                           f"the process group {world}")
    return init_device_mesh(device_type, mesh.sizes,
                            mesh_dim_names=mesh.axis_names)


def describe(dmesh) -> Mesh:
    """The :class:`Mesh` description of a ``DeviceMesh`` (its dimension
    names and sizes), which the sharding rules read."""
    return Mesh(tuple(dmesh.mesh_dim_names), tuple(dmesh.mesh.shape))


@contextlib.contextmanager
def fake_device_mesh(mesh: Mesh, device_type: str = "cuda") -> Iterator:
    """A ``DeviceMesh`` of ``mesh.sizes`` with the mesh's axis names over a
    ``fake`` process group of ``mesh.size`` ranks, this process rank 0: its
    collectives move nothing and return tensors of the right shape, so a
    step on DTensors whose local tensors are on the meta device runs, and
    its collectives can be counted, without a byte allocated or a peer.
    The mesh is of the cards' device type by default, so that DTensor
    takes the cards' collectives (on a ``"cpu"`` mesh it replaces an
    all-to-all by an all-gather, as for a gloo group); no card is needed.
    The group is made on entry and destroyed on exit, so that the process
    can start a real group afterwards; entering while a group exists
    raises ``RuntimeError``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_device_mesh needs a process without a "
                           "process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield init_device_mesh(device_type, mesh.sizes,
                               mesh_dim_names=mesh.axis_names)
    finally:
        dist.destroy_process_group()
