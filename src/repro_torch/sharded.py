"""The sharded step: the model, its loss and its kernels on DTensors laid
out by ``launch.sharding`` on any ``DeviceMesh``.

The model's code is the same for plain tensors and DTensors; these
helpers are where the two part, and each is a no-op on plain tensors or
called only for a DTensor:

* :func:`plain_as_replicated`: the plain tensors a step makes (positions,
  masks, RoPE tables) take part as replicated.
* :func:`reduce_rows` and :func:`gather_grad`: the reductions of a split
  product, placed where the reference's partitioner places them: the
  output of a row-split product (attention's output projection, the MLP's
  down product, the experts' combine, the embedding's vocabulary-split
  gather) is all-reduced at once, and the gradient of an activation that
  enters column-split products is reduced once where it enters them.
* :func:`local_attention`: attention (the kernels of ``kernels.ops`` and the
  training route's plain attention) on each rank's own shards through
  ``torch.distributed.tensor.experimental.local_map``, wherever a shard's
  work is self-contained.

Attention is self-contained with the batch on the data axes and either
* the heads on ``model``: every rank attends its query heads over the
  key/value heads they read.  Where the key/value heads do not divide the
  axis they are whole on every rank, and each rank picks the ones its
  query heads read (by its coordinate on the axis);
* the queries on ``model`` along the sequence (``cfg.seq_shard_attn``, set
  by the model before attention) with keys and values whole: each rank
  attends its rows, causal by absolute position from its first row;
* nothing on ``model``: every rank repeats the whole attention (heads that
  do not divide the axis), which the dry run's per-device counts show.
Operands in any other layout are redistributed to these first; a
redistribution issues collectives, and ``launch.collectives`` counts them
with the step's.  In the backward, the gradient of keys and values read
whole on every rank is a partial sum over ``model``.
"""
from __future__ import annotations

import contextlib
import sys
from typing import Callable, List, Optional, Tuple

import torch

MODEL = "model"


_NO_CONTEXT = contextlib.nullcontext()


def is_dtensor(t) -> bool:
    """True for a DTensor.  Never imports DTensor's module (a second of a
    process's start): where it is not loaded, no DTensor exists."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def plain_as_replicated(t):
    """A context in which, while a step runs on DTensors (``t`` is one),
    the plain tensors it makes (positions, masks, RoPE tables, zero
    scalars) take part as replicated: DTensor's ``implicit_replication``,
    entered once (it does not nest).  A no-op for a plain ``t``."""
    if (not is_dtensor(t)
            or torch._C._get_dtensor_allow_implicit_replication()):
        return _NO_CONTEXT
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def model_rank(dmesh) -> int:
    """This rank's coordinate on the mesh's ``model`` axis (0 without
    one)."""
    names = dmesh.mesh_dim_names or ()
    return dmesh.get_local_rank(MODEL) if MODEL in names else 0


def redistribute(t, placements):
    """``t`` in ``placements`` (a collective where they differ: counted)."""
    if list(t.placements) == list(placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def as_batch_sharded(t, like):
    """A plain tensor whose dimension 0 is the batch, laid out as ``like``'s
    batch (its data-axis placements; replicated elsewhere): every rank
    takes its rows of the same tensor, no collective."""
    from torch.distributed.tensor import DTensor, Replicate
    dm = like.device_mesh
    d = t if is_dtensor(t) else DTensor.from_local(
        t, dm, [Replicate()] * dm.ndim, run_check=False)
    return redistribute(d, batch_placements(like.placements, dm))


def attention_layout(q, k, *, hdim: int, sdim: Optional[int]):
    """(mode, q placements, key/value placements, key/value gradient
    placements) of the self-contained layout for q (B, ..., Hq, ...) and
    k, v (B, ..., Hkv, ...), heads at ``hdim`` and q's sequence at
    ``sdim`` (None: one query).  mode is "seq", "heads", "select" (q
    heads on ``model``, key/value heads whole) or "whole"."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    dm = q.device_mesh
    Hq, Hkv = q.shape[hdim], k.shape[hdim]
    mode = "whole"
    qt: List = []
    kt: List = []
    kg: List = []
    for i, ax in enumerate(dm.mesh_dim_names):
        n, cur = dm.size(i), q.placements[i]
        if ax != MODEL:
            p = Shard(0) if cur == Shard(0) else Replicate()
            qt.append(p)
            kt.append(p)
            kg.append(p)
        elif n > 1 and sdim is not None and cur == Shard(sdim) \
                and q.shape[sdim] % n == 0:
            mode = "seq"
            qt.append(Shard(sdim))
            kt.append(Replicate())
            kg.append(Partial())
        elif n > 1 and Hq % n == 0:
            qt.append(Shard(hdim))
            if Hkv % n == 0:
                mode = "heads"
                kt.append(Shard(hdim))
                kg.append(Shard(hdim))
            else:
                mode = "select"
                kt.append(Replicate())
                kg.append(Partial())
        else:
            qt.append(Replicate())
            kt.append(Replicate())
            kg.append(Replicate())
    return mode, qt, kt, kg


def _select_kv(k, v, hq: int, first: int, G: int, hdim: int):
    """The key/value heads that local query heads ``first ..
    first + hq - 1`` read (G query heads a key/value head), in an order
    that keeps the local call's grouping: a run of whole groups, the one
    head a part of a group reads, or one head per query head."""
    if hq % G == 0:
        return (k.narrow(hdim, first // G, hq // G),
                v.narrow(hdim, first // G, hq // G))
    if G % hq == 0:
        return k.narrow(hdim, first // G, 1), v.narrow(hdim, first // G, 1)
    idx = (first + torch.arange(hq, device=k.device)) // G
    return k.index_select(hdim, idx), v.index_select(hdim, idx)


def local_attention(local_fn: Callable, q, k, v, *, hdim: int,
                    sdim: Optional[int], extras: Tuple = (),
                    extra_placements: Tuple = ()):
    """Attention on DTensors through ``local_map``: q, k and v are brought
    to :func:`attention_layout` (redistributed where they differ), and
    each rank calls ``local_fn(q, k, v, q_start, *extras)`` on its local
    tensors, k and v holding exactly the heads its query heads read;
    ``q_start`` is the global index of its first query row where the
    queries are split along the sequence, else None.  ``extras`` are
    DTensors already in ``extra_placements``.  Returns a DTensor in q's
    layout."""
    from torch.distributed.tensor.experimental import local_map
    dm = q.device_mesh
    G = q.shape[hdim] // k.shape[hdim]
    mode, qt, kt, kg = attention_layout(q, k, hdim=hdim, sdim=sdim)
    q, k, v = redistribute(q, qt), redistribute(k, kt), redistribute(v, kt)

    def local(ql, kl, vl, *ex):
        r = model_rank(dm)
        q_start = r * ql.shape[sdim] if mode == "seq" else None
        if mode == "select":
            hq = ql.shape[hdim]
            kl, vl = _select_kv(kl, vl, hq, r * hq, G, hdim)
        return local_fn(ql, kl, vl, q_start, *ex)
    fn = local_map(local, out_placements=qt,
                   in_placements=(qt, kt, kt) + tuple(extra_placements),
                   in_grad_placements=(qt, kg, kg) + tuple(extra_placements),
                   device_mesh=dm)
    return fn(q, k, v, *extras)


def batch_placements(placements, dmesh) -> list:
    """Rows only: ``Shard(0)`` where ``placements`` shard dimension 0 on a
    data axis, ``Replicate()`` elsewhere (the model axis included)."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0) if (p == Shard(0) and dmesh.mesh_dim_names[i] != MODEL)
            else Replicate() for i, p in enumerate(placements)]


def shard_sequence(q, sdim: int):
    """q with its sequence dimension ``sdim`` split over ``model`` (the
    reference's ``with_sharding_constraint(q, P(None, "model", None,
    None))``), where the axis divides it; as it is otherwise."""
    from torch.distributed.tensor import Shard
    dm = q.device_mesh
    names = dm.mesh_dim_names
    if MODEL not in names:
        return q
    i = names.index(MODEL)
    n = dm.size(i)
    if n == 1 or q.shape[sdim] % n:
        return q
    want = list(q.placements)
    want[i] = Shard(sdim)
    return redistribute(q, want)


def reduce_rows(t):
    """``t`` (B, ...) with only its rows split (:func:`batch_placements`):
    where a row-parallel product left partial sums over ``model`` (the
    attention's output projection, the MLP's down product, the experts'
    combine), their all-reduce, as the reference's partitioner places it.
    A plain tensor as it is."""
    if not is_dtensor(t):
        return t
    return redistribute(t, batch_placements(t.placements, t.device_mesh))


def replicated(t):
    """A DTensor whole on every rank (its partial sums reduced, its shards
    gathered); a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return redistribute(t, [Replicate()] * t.device_mesh.ndim)


def gather_grad(h):
    """``h`` (a DTensor whole over ``model``, entering products split over
    it: the QKV, MLP and expert products) whose gradient, a partial sum
    over ``model`` from those products, is reduced once here, to ``h``'s
    own layout (an all-reduce), rather than carried partial into the
    residual stream: the backward of the reference's row/column split.  A
    plain tensor, or one that does not require grad, as it is."""
    if not is_dtensor(h) or not h.requires_grad:
        return h
    placements = list(h.placements)
    h.register_hook(lambda g: redistribute(g, placements))
    return h


def local_rows(fn: Callable, n_out: int, params: dict, x, *rows):
    """``fn(params, x, *rows)`` on each rank's own rows, whole over the
    other axes: the parameters (a dict of DTensors), x and ``rows``
    (tensors whose dimension 0 is the batch: a state, a per-row index;
    plain ones are taken as replicated) are brought to that layout first
    (gathers over ``model``: counted), and ``fn`` runs through
    ``local_map`` on the local tensors, returning a tuple of ``n_out``
    tensors with the batch first.  The parameters' gradients are partial
    sums over the data axes the rows split.  Returns the tuple as DTensors
    in x's row layout."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    dm = x.device_mesh
    row = batch_placements(x.placements, dm)
    whole = [Replicate()] * dm.ndim
    pgrad = [Partial() if p == Shard(0) else Replicate() for p in row]
    keys = sorted(params)
    args = [redistribute(params[k], whole) for k in keys]
    args.append(redistribute(x, row))
    args += [redistribute(as_batch_sharded(r, x), row) for r in rows]

    def local(*a):
        return fn(dict(zip(keys, a[:len(keys)])), *a[len(keys):])
    n_in = 1 + len(rows)
    return local_map(local, out_placements=(row,) * n_out,
                     in_placements=(whole,) * len(keys) + (row,) * n_in,
                     in_grad_placements=(pgrad,) * len(keys) + (row,) * n_in,
                     device_mesh=dm)(*args)
