"""Divisibility-aware sharding rules for every parameter, optimizer,
cache and batch tree of the port (the JAX package's
``launch/sharding.py``).

The strategy is the reference's: the batch over ``("pod", "data")``;
heads, FFN hidden widths, MoE experts, Mamba inner channels and the
vocabulary over ``"model"``.  :func:`partition` drops any mesh axis that
does not divide its dimension (8 KV heads on a 16-way model axis stay
replicated), so every (architecture x shape x mesh) gets a spec without
per-architecture tuning.

A spec is a tuple with one entry a dimension: ``None`` (replicated), an
axis name, or a tuple of axis names, the entries of the reference's
``PartitionSpec``.  The ``*_shardings`` functions map the port's flat
``/``-keyed trees (the keys of the npz that ``train/checkpoint.py::save``
writes; a cache's leaves are ``"<kind>/<field>"``: ``self/k``, ``ssm/h``,
...) to specs, and :func:`to_placements` turns a spec into the DTensor
placements of a ``DeviceMesh`` with the same axes.  :func:`distribute_tree`
places a tree by its specs as DTensors: real tensors by
``distribute_tensor``, meta tensors as their local shards' meta tensors
(``DTensor.from_local``), so that nothing is allocated.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.launch.mesh import data_axes

Axis = Union[None, str, Sequence[str]]
Spec = Tuple[Any, ...]


def _axis_size(mesh, axis: Axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, str):
        return mesh.shape.get(axis, 0) or 0
    return int(math.prod(mesh.shape.get(a, 0) or 0 for a in axis))


def partition(mesh, shape: Sequence[int], axes: Sequence[Axis]) -> Spec:
    """A spec keeping only the axes that exist in ``mesh`` and divide
    their dimension."""
    spec = []
    for dim, ax in zip(shape, axes):
        if ax is None:
            spec.append(None)
            continue
        size = _axis_size(mesh, ax)
        if size > 1 and dim % size == 0:
            spec.append(ax if isinstance(ax, str) else tuple(ax))
        else:
            spec.append(None)
    return tuple(spec)


def _param_axes(key_path: str, shape) -> list:
    """Logical axes for a parameter leaf, by its last name and rank.
    Layer-stacked leaves carry a leading L dimension (never sharded)."""
    name = key_path.split("/")[-1]
    nd = len(shape)

    def pad(trailing):  # left-pad with None for the optional layer-stack dim
        return [None] * (nd - len(trailing)) + list(trailing)

    if name == "embed":
        return pad(["model", None])                  # (V, d)
    if name == "lm_head":
        return pad([None, "model"])                  # (d, V)
    if name == "out_bias":
        return pad(["model"])                        # (V,)
    if name in ("wq", "wk", "wv"):
        return pad([None, "model", None])            # (d, H, hd)
    if name == "wo":
        return pad(["model", None, None])            # (H, hd, d)
    if name in ("bq", "bk", "bv"):
        return pad(["model", None])                  # (H, hd)
    is_expert = "moe" in key_path.split("/") and "shared" not in key_path
    if name in ("w_gate", "w_up", "w_fc"):
        if is_expert:   # expert-stacked (E, d, f): experts first, else f
            return pad(["model", None, "model_fallback_f"])
        return pad([None, "model"])
    if name in ("w_down", "w_proj"):
        if is_expert:   # (E, f, d)
            return pad(["model", "model_fallback_f", None])
        return pad(["model", None])
    if name in ("b_fc",):
        return pad(["model"])
    if name == "router":
        return pad([None, None])
    if name == "in_proj":
        return pad([None, "model"])                  # (d, d_in_proj)
    if name == "out_proj":
        return pad(["model", None])                  # (di, d)
    if name == "conv_w":
        return pad([None, "model"])                  # (w, ch)
    if name == "conv_b":
        return pad(["model"])
    return [None] * nd                               # norms, scalars, biases


def param_pspec(mesh, key_path: str, shape) -> Spec:
    """A parameter's spec.  The MoE fallback: the experts on ``"model"``
    where their count divides it, else ``"model"`` moves to each expert's
    hidden width."""
    axes = _param_axes(key_path, tuple(shape))
    size = _axis_size(mesh, "model")
    primary_ok = all(
        dim % size == 0 for dim, ax in zip(shape, axes) if ax == "model"
    ) and size > 1
    resolved = []
    for dim, ax in zip(shape, axes):
        if ax == "model":
            resolved.append("model" if primary_ok else None)
        elif ax == "model_fallback_f":
            use = (not primary_ok) and size > 1 and dim % size == 0
            resolved.append("model" if use else None)
        else:
            resolved.append(ax)
    return tuple(resolved)


def batch_pspec(mesh, shape: Sequence[int]) -> Spec:
    """(B, ...) activations: the batch on ("pod", "data") where it
    divides."""
    da = data_axes(mesh)
    return partition(mesh, shape, [da] + [None] * (len(shape) - 1))


def cache_pspec(mesh, key_path: str, shape) -> Spec:
    """Decode-cache leaves are (L, B, ...): the batch on the data axes,
    heads or channels on ``"model"`` where they divide; K/V fall back to
    sharding the ring's width when the KV-head count does not divide the
    model axis (8 heads on 16)."""
    name = key_path.split("/")[-1]
    da = data_axes(mesh)
    size = _axis_size(mesh, "model")
    if name in ("k", "v"):      # (L, B, Hkv, W, hd)
        if size > 1 and shape[2] % size == 0:
            return partition(mesh, shape, [None, da, "model", None, None])
        return partition(mesh, shape, [None, da, None, "model", None])
    if name == "pos":           # (L, B, W)
        return partition(mesh, shape, [None, da, None])
    if name == "h":             # (L, B, H, N, P)
        return partition(mesh, shape, [None, da, "model", None, None])
    if name == "conv":          # (L, B, w, ch)
        return partition(mesh, shape, [None, da, None, "model"])
    return partition(mesh, shape, [None, da] + [None] * (len(shape) - 2))


def param_shardings(mesh, params: Mapping[str, Any]) -> Dict[str, Spec]:
    """{key: spec} for a flat parameter (or moment) tree; each leaf needs
    only a ``shape``."""
    return {k: param_pspec(mesh, k, tuple(v.shape))
            for k, v in params.items()}


def opt_state_shardings(mesh, opt_state: Mapping[str, Any],
                        params_sharding: Mapping[str, Spec]
                        ) -> Dict[str, Any]:
    """The AdamW state ({mu, nu, step}): the moments as their parameters,
    the step replicated."""
    return {"mu": dict(params_sharding), "nu": dict(params_sharding),
            "step": ()}


def batch_shardings(mesh, batch: Mapping[str, Any]) -> Dict[str, Spec]:
    return {k: batch_pspec(mesh, tuple(v.shape)) for k, v in batch.items()}


def cache_leaves(cache: Mapping[str, Any]) -> Dict[str, Any]:
    """The flat ``"<kind>/<field>"`` leaves of a decode cache
    ({"self": LayerCache, "ssm": SSMCache, ...})."""
    return {f"{kind}/{field}": leaf for kind, tup in cache.items()
            if tup is not None
            for field, leaf in zip(tup._fields, tup)}


def cache_shardings(mesh, cache: Mapping[str, Any]) -> Dict[str, Spec]:
    """{"<kind>/<field>": spec} for a decode cache (a dict of
    ``LayerCache``/``SSMCache``, or its flat leaves)."""
    leaves = (cache_leaves(cache)
              if any(hasattr(v, "_fields") for v in cache.values())
              else cache)
    return {k: cache_pspec(mesh, k, tuple(v.shape))
            for k, v in leaves.items()}


def shard_factor(mesh, spec: Spec) -> int:
    """The number of pieces a tensor of this spec is cut into."""
    n = 1
    for ax in spec:
        if ax is not None:
            n *= _axis_size(mesh, ax)
    return n


def to_placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on a mesh with the same axis names,
    one a mesh dimension: ``Shard(d)`` where tensor dimension ``d`` names
    that axis (alone or in a tuple), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(getattr(mesh, "mesh_dim_names", None) or mesh.axis_names)
    out = []
    for axis in names:
        dim: Optional[int] = next(
            (d for d, ax in enumerate(spec)
             if ax == axis or (isinstance(ax, tuple) and axis in ax)), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return out


def local_shape(shape: Sequence[int], placements, dmesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a tensor of global ``shape`` under
    ``placements`` on ``dmesh`` (the rules shard only where a mesh axis
    divides its dimension, so every rank's shard has this shape)."""
    from torch.distributed.tensor import Shard
    out = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = dmesh.size(i)
            if out[p.dim] % n:
                raise ValueError(f"dimension {p.dim} of {tuple(shape)} does "
                                 f"not divide over {n} ranks")
            out[p.dim] //= n
    return tuple(out)


def distribute_leaf(t, spec: Spec, dmesh):
    """One tensor as a DTensor laid out by ``spec`` on ``dmesh``: a meta
    tensor as the meta tensor of its local shard (nothing allocated), a
    real one by ``distribute_tensor`` (each rank keeps its own slice of the
    same tensor, no collective)."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor
    placements = to_placements(spec, dmesh)
    if t.device.type == "meta":
        local = torch.empty(local_shape(t.shape, placements, dmesh),
                            dtype=t.dtype, device="meta")
        return DTensor.from_local(local, dmesh, placements, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return distribute_tensor(t, dmesh, placements, src_data_rank=None)


def _flat_specs(specs, prefix: str = "") -> Dict[str, Spec]:
    """{"a/b": spec} of nested spec mappings (a spec is a plain tuple)."""
    out: Dict[str, Spec] = {}
    for k, v in specs.items():
        if isinstance(v, Mapping):
            out.update(_flat_specs(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(v)
    return out


def distribute_tree(tree, specs, dmesh):
    """``tree`` with every tensor a DTensor laid out by its spec on
    ``dmesh`` (:func:`distribute_leaf`).  ``tree`` is a ``/``-keyed flat
    mapping, or nested mappings and named tuples (an optimizer state, a
    decode cache), and ``specs`` gives each leaf's spec under its flat
    ``/`` path (``"self/k"``, ``"mu/layers/attn/wq"``), flat or nested;
    the result has the tree's structure."""
    flat = _flat_specs(specs)

    def place(node, prefix):
        if node is None:
            return None
        if hasattr(node, "_fields"):
            return type(node)(*(place(v, f"{prefix}{f}/")
                                for f, v in zip(node._fields, node)))
        if isinstance(node, Mapping):
            return {k: place(v, f"{prefix}{k}/") for k, v in node.items()}
        key = prefix[:-1]
        if key not in flat:
            raise KeyError(f"no spec for leaf {key!r}")
        return distribute_leaf(node, flat[key], dmesh)
    return place(tree, "")


def full_cache_leaf(name: str, shape: Sequence[int], fill, dtype, dmesh,
                    device):
    """A decode-cache leaf ``name`` (``"k"``, ``"v"``, ``"pos"``, ...) of
    global ``shape`` filled with ``fill``, as a DTensor laid out by
    :func:`cache_pspec` on ``dmesh``: each rank makes its own shard on
    ``device`` (meta: nothing allocated)."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import describe
    placements = to_placements(cache_pspec(describe(dmesh), name,
                                           tuple(shape)), dmesh)
    local = torch.full(local_shape(shape, placements, dmesh), fill,
                       dtype=dtype, device=device)
    return DTensor.from_local(local, dmesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())
