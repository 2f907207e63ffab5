"""Attention of the serving path: prefill, the ring and paged caches and
their decode.

One ring cache of width ``W`` per layer holds, for every slot, the K/V of
the most recent token at each ring position ``p % W`` and that token's
absolute position (``pos``, -1 = empty), exactly as the JAX package's
``LayerCache``.

Decode reads the ring through the paged decode kernel with the ring viewed
as a pool of one block per slot: one layer's ``k, v (B, Hkv, W, hd)`` is a
pool with ``NB = B`` and ``bs = W``, ``pos (B, W)`` is the pool's position
plane and the table is ``arange(B)[:, None]``.  The new token is written
into its ring slot *before* the layer attends (an in-place write into the
cache), and the kernel's mask ``pos <= step & pos > step - W`` then sees the
same token set as the JAX decode's deferred-write merge: the slot's
previous occupant (position ``step - W``) has been overwritten, and the
new token is present.

The paged cache (:class:`PagedCache`) factors the same ring through one
indirection: a pool of ``bs``-token blocks shared by all slots and a table
per slot, so that the token at absolute position ``p`` of slot ``b`` lives
at ``pool[table[b, (p % W) // bs], p % bs]``.  Its decode also writes
before it attends (:func:`write_paged_positions`,
:func:`paged_decode_layer_attention`), and the kernel walks the logical
positions in the same order whatever ``bs`` is, so a paged slot and a ring
slot holding the same tokens give the same bits.

Chunked prefill writes a prompt into the pool a chunk at a time: a chunk's
queries attend over the slot's context blocks, gathered from the pool
(:func:`gather_context`), and the chunk itself, by absolute position
(:func:`suffix_attention`, the flash kernel with position masks).

The encoder-decoder's cross-attention has a ring of its own per layer
(``cache["cross"]``): the prefill packs the projected encoder memory's K/V
into it at positions 0..M-1 (no RoPE), and decode reads it and never
writes it (:func:`cross_decode_attention`).  Bidirectional attention (the
encoder's self-attention, and cross-attention's prefill, where the T keys
of the memory differ in number from the S queries) takes the flash
kernel's non-causal route (:func:`full_attention`).

Training attends through :func:`chunked_attention`, a differentiable masked
softmax in plain torch ops (the JAX package trains through its jnp
``chunked_attention`` too, never through a Pallas kernel); no kernel has a
backward, and ``kernels.ops`` refuses to run one under grad.  Past 512 x
512 scores it takes the JAX package's blocked route: an online softmax over
512-key blocks, each key step recomputed in the backward.

On DTensors (a sharded step), attention runs on each rank's shards
(``repro_torch.sharded``): the prefill and decode kernels through
``kernels.ops``, the training route through
:func:`sharded_chunked_attention`.  Caches are DTensors laid out by
``launch.sharding.cache_pspec`` (:func:`empty_cache_for`), and each rank
writes a decode step's position and K/V into its own slots
(:func:`write_ring_positions`, :func:`ring_decode_attention`).  A paged
pool has no sharded route.

A sliding window (``window``, tokens) narrows every route to the keys at
positions ``> q_pos - window``; the ring's own eviction (``pos > step -
W``) applies on top of it in decode.  Keys are stored post-RoPE (the
model rotates q and k at absolute positions before any cache write), so
attention here never sees positions other than through the masks.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import sharded
from repro_torch.kernels import ops
from repro_torch.models.layers import row_products

NEG_INF = -1e30


class LayerCache(NamedTuple):
    """Decode cache, stacked over layers by the model."""
    k: torch.Tensor       # (L, B, Hkv, W, hd)
    v: torch.Tensor       # (L, B, Hkv, W, hd)
    pos: torch.Tensor     # (L, B, W) int32 absolute positions, -1 = empty


def project_qkv(x: torch.Tensor, wq, wk, wv, bq=None, bk=None, bv=None,
                xkv: Optional[torch.Tensor] = None,
                rows: Optional[int] = None):
    """x (B, S, d) -> q (B, S, Hq, hd), k and v (B, T, Hkv, hd), k and v
    from ``xkv`` (B, T, d) where given (cross-attention: the encoder's
    memory), else from x; the QKV biases (Hq|Hkv, hd), where given, are
    added in x's dtype; ``rows`` as ``layers.row_products``'."""
    dt = x.dtype
    d = x.shape[2]
    xkv = x if xkv is None else xkv.to(dt)
    B, T = xkv.shape[:2]
    q = project_q(x, wq, bq, rows)
    k = row_products(xkv, wk.to(dt).reshape(d, -1), rows).view(
        B, T, wk.shape[1], wk.shape[2])
    v = row_products(xkv, wv.to(dt).reshape(d, -1), rows).view(
        B, T, wv.shape[1], wv.shape[2])
    if bk is not None:
        k = k + bk.to(dt)
        v = v + bv.to(dt)
    return q, k, v


def project_q(x: torch.Tensor, wq, bq=None,
              rows: Optional[int] = None) -> torch.Tensor:
    """x (B, S, d) -> q (B, S, Hq, hd), with the bias (Hq, hd) where
    given, in x's dtype; ``rows`` as ``layers.row_products``'."""
    dt = x.dtype
    B, S, d = x.shape
    q = row_products(x, wq.to(dt).reshape(d, -1), rows).view(
        B, S, wq.shape[1], wq.shape[2])
    return q if bq is None else q + bq.to(dt)


def output_projection(o: torch.Tensor, wo: torch.Tensor,
                      rows: Optional[int] = None) -> torch.Tensor:
    """o (B, S, Hq, hd) -> (B, S, d); ``rows`` as
    ``layers.row_products``'."""
    B, S = o.shape[:2]
    return row_products(o.reshape(B, S, -1),
                        wo.to(o.dtype).reshape(-1, wo.shape[-1]), rows)


def _valid(q_pos, k_pos, causal: bool, window):
    """(B, 1, 1, Sq, Skv) mask: key valid (k_pos >= 0) and, when causal,
    ``0 <= q_pos - k_pos < window``."""
    valid = (k_pos >= 0)[:, None, None, None, :]
    if causal:
        rel = q_pos[:, None, None, :, None] - k_pos[:, None, None, None, :]
        valid = valid & (rel >= 0)
        if window is not None:
            valid = valid & (rel < window)
    return valid


def chunked_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                      window=None, q_per_kv: int = 1, q_block: int = 512,
                      kv_block: int = 512) -> torch.Tensor:
    """The JAX package's ``models/attention.py::chunked_attention`` in
    plain, differentiable torch ops: the training route's attention.

    q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd); q_pos (B, Sq) and k_pos
    (B, Skv) int positions (or (Sq,), (Skv,)), a key with k_pos < 0
    invalid.  Scores in fp32, masked with -1e30 (a row with no valid key
    averages its values, as JAX's dense form); the product with v in v's
    dtype.  Up to ``q_block * kv_block`` scores it is one dense softmax;
    past that, as JAX, an online softmax over ``kv_block``-key blocks for
    each ``q_block`` of queries (both padded, padded keys invalid), each key
    step rematerialised in the backward (``torch.utils.checkpoint``, JAX's
    ``jax.checkpoint(policy=nothing_saveable)``), so that the scores of
    only one block are ever live.  Returns (B, Sq, Hq, hd)."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = q_per_kv
    if Hq != Hkv * G:
        raise ValueError(f"{Hq} query heads != {Hkv} kv heads x {G}")
    if q_pos.dim() == 1:
        q_pos = q_pos[None].expand(B, Sq)
    if k_pos.dim() == 1:
        k_pos = k_pos[None].expand(B, Skv)
    scale = hd ** -0.5
    if Sq * Skv <= q_block * kv_block:
        qg = q.reshape(B, Sq, Hkv, G, hd)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
        valid = _valid(q_pos, k_pos, causal, window)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
        return o.reshape(B, Sq, Hq, hd)

    def pad(x, mult, value=0):
        n = (-x.shape[1]) % mult
        if n == 0:
            return x
        widths = [0, 0] * (x.dim() - 2) + [0, n]
        return torch.nn.functional.pad(x, widths, value=value)
    qp = pad(q, q_block)
    qpos = pad(q_pos, q_block)
    kp, vp = pad(k, kv_block), pad(v, kv_block)
    kpos = pad(k_pos, kv_block, value=-1)     # padded keys are invalid
    nq, nk = qp.shape[1] // q_block, kp.shape[1] // kv_block

    def kv_step(o, m, l, q_i, qp_i, k_i, v_i, kp_i):
        s = torch.einsum("bqhgd,bkhd->bhgqk", q_i, k_i).float() * scale
        s = torch.where(_valid(qp_i, kp_i, causal, window), s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(dim=-1)
        o_new = o * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(v_i.dtype), v_i).float()
        return o_new, m_new, l_new

    outs = []
    for iq in range(nq):
        sl = slice(iq * q_block, (iq + 1) * q_block)
        q_i = qp[:, sl].reshape(B, q_block, Hkv, G, hd)
        qp_i = qpos[:, sl]
        o = q.new_zeros((B, Hkv, G, q_block, hd), dtype=torch.float32)
        m = torch.full((B, Hkv, G, q_block), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Hkv, G, q_block), dtype=torch.float32,
                        device=q.device)
        for ik in range(nk):
            kl = slice(ik * kv_block, (ik + 1) * kv_block)
            o, m, l = checkpoint(kv_step, o, m, l, q_i, qp_i, kp[:, kl],
                                 vp[:, kl], kpos[:, kl], use_reentrant=False)
        outs.append(o / l.clamp(min=1e-30)[..., None])
    out = torch.cat(outs, dim=3)                      # (B, Hkv, G, Sq_p, hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, nq * q_block, Hq, hd)
    return out[:, :Sq].to(q.dtype)


def sharded_chunked_attention(q, k, v, *, causal: bool = True,
                              window=None) -> torch.Tensor:
    """:func:`chunked_attention` on DTensors q (B, S, Hq, hd), k, v (B, T,
    Hkv, hd), at positions by index (0.. for the keys, and for the queries
    from the first row a rank holds): each rank over its shards
    (``sharded.local_attention``), differentiable."""
    def local(ql, kl, vl, q_start):
        qp = torch.arange(ql.shape[1], device=ql.device) + (q_start or 0)
        kp = torch.arange(kl.shape[1], device=ql.device)
        return chunked_attention(ql, kl, vl, qp, kp, causal=causal,
                                 window=window,
                                 q_per_kv=ql.shape[2] // kl.shape[2])
    return sharded.local_attention(local, q, k, v, hdim=2, sdim=1)


def prefill_attention(q, k, v, window: Optional[int] = None
                      ) -> torch.Tensor:
    """Causal self-attention over positions 0..S-1 (right padding sits at
    later positions, so index causality equals position causality), within
    ``window`` tokens where given.
    q: (B, S, Hq, hd), k, v: (B, S, Hkv, hd) -> (B, S, Hq, hd)."""
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True, window=window)
    return o.transpose(1, 2)


def full_attention(q, k, v) -> torch.Tensor:
    """Bidirectional attention: every query sees every key (the encoder's
    self-attention over its frames; cross-attention's prefill over the
    encoder memory, T keys for S queries), no window.
    q: (B, S, Hq, hd), k, v: (B, T, Hkv, hd) -> (B, S, Hq, hd)."""
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=False)
    return o.transpose(1, 2)


def suffix_attention(q, k, v, ctx_k, ctx_v, positions, ctx_pos,
                     window: Optional[int] = None) -> torch.Tensor:
    """One layer's suffix-prefill attention (mode "suffix" of the JAX
    package's attention): the chunk's projected (and, with RoPE, rotated)
    heads q (B, Sc, Hq, hd) and k, v (B, Sc, Hkv, hd) at ``positions``
    (B, Sc) attend over the context ``ctx_k``/``ctx_v`` (B, C, Hkv, hd) at
    ``ctx_pos`` (B, C) followed by the chunk, causal by position (-1 =
    invalid) and within ``window``.  Returns (B, Sc, Hq, hd); the caller
    keeps k and v for its block write."""
    return ops.suffix_prefill_attention(q, k, v, ctx_k, ctx_v, positions,
                                        ctx_pos, causal=True, window=window,
                                        q_per_kv=q.shape[2] // k.shape[2])


def ring_slots(S: int, width: int, device):
    """(tok, pos_slot): which prefill token each of the W ring slots holds,
    and its position (-1 = empty).  Slot j holds the most recent token with
    position % W == j (positions 0..S-1)."""
    W = width
    j = torch.arange(W, device=device)
    if S <= W:
        tok = j.clamp(max=S - 1)
        pos_slot = torch.where(j < S, j, -1)
    else:
        tok = S - W + torch.remainder(j - (S - W), W)
        pos_slot = tok
    return tok, pos_slot.to(torch.int32)


def cache_from_prefill(k, v, positions, width: int) -> LayerCache:
    """One layer's ring of width W from its prefill K/V (a LayerCache
    without the layer axis: k, v (B, Hkv, W, hd), pos (B, W)).
    k, v: (B, S, Hkv, hd); positions: (B, S) absolute, 0..S-1 in order."""
    B, S = k.shape[:2]
    tok, pos_slot = ring_slots(S, width, k.device)
    kc = k.index_select(1, tok).transpose(1, 2)
    vc = v.index_select(1, tok).transpose(1, 2)
    base = positions[:, :1].to(torch.int32)
    pos = torch.where(pos_slot[None, :] >= 0, pos_slot[None, :] + base,
                      torch.full_like(pos_slot[None, :], -1))
    return LayerCache(k=kc, v=vc, pos=pos.to(torch.int32))


def empty_cache(n_layers: int, batch: int, n_kv_heads: int, width: int,
                head_dim: int, dtype, device) -> LayerCache:
    shape = (n_layers, batch, n_kv_heads, width, head_dim)
    return LayerCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((n_layers, batch, width), -1, dtype=torch.int32,
                       device=device))


def empty_cache_for(x, n_layers: int, batch: int, n_kv_heads: int,
                    width: int, head_dim: int) -> LayerCache:
    """:func:`empty_cache` in x's dtype on x's device, or, for a DTensor
    x, its leaves as DTensors on x's mesh laid out by
    ``launch.sharding.cache_pspec``, each rank making only its shard."""
    if not sharded.is_dtensor(x):
        return empty_cache(n_layers, batch, n_kv_heads, width, head_dim,
                           x.dtype, x.device)
    from repro_torch.launch.sharding import full_cache_leaf
    dm, dev = x.device_mesh, x.to_local().device
    kv = (n_layers, batch, n_kv_heads, width, head_dim)
    return LayerCache(
        k=full_cache_leaf("k", kv, 0, x.dtype, dm, dev),
        v=full_cache_leaf("v", kv, 0, x.dtype, dm, dev),
        pos=full_cache_leaf("pos", (n_layers, batch, width), -1,
                            torch.int32, dm, dev))


def write_ring_positions(cache: LayerCache, step: torch.Tensor) -> torch.Tensor:
    """Record each slot's new token position ``step`` (B,) at ring slot
    ``step % W`` of every layer's position plane, in place.  Returns the
    (B,) ring slots (on DTensors, each rank writes its own rows and gets
    the slots of its rows, a local tensor)."""
    if sharded.is_dtensor(cache.pos):
        pos = cache.pos.to_local()
        st = sharded.as_batch_sharded(step, cache.k[0]).to_local()
        slot = torch.remainder(st.long(), pos.shape[-1])
        rows = torch.arange(st.shape[0], device=pos.device)
        pos[:, rows, slot] = st.to(torch.int32)
        return slot
    W = cache.pos.shape[-1]
    slot = torch.remainder(step.long(), W)
    rows = torch.arange(step.shape[0], device=step.device)
    cache.pos[:, rows, slot] = step.to(torch.int32)
    return slot


def ring_decode_attention(q, k_new, v_new, cache: LayerCache, layer: int,
                          slot: torch.Tensor, step: torch.Tensor,
                          table: torch.Tensor,
                          window: Optional[int] = None) -> torch.Tensor:
    """One layer's decode attention against its ring.

    q: (B, 1, Hq, hd); k_new, v_new: (B, 1, Hkv, hd); ``slot`` (B,) from
    :func:`write_ring_positions`; ``table`` = arange(B)[:, None] int32.
    Writes the new K/V into the layer's ring in place, then attends through
    the paged decode kernel (positions in ``(step - W, step]`` and, with a
    ``window``, ``> step - window``).  Returns (B, 1, Hq, hd)."""
    kl, vl = cache.k[layer], cache.v[layer]
    if sharded.is_dtensor(kl):
        _write_ring_sharded(kl, k_new[:, 0], slot)
        _write_ring_sharded(vl, v_new[:, 0], slot)
        o = ops.paged_decode_attention(q[:, 0], kl, vl, table,
                                       cache.pos[layer], step, window=window)
        return o[:, None]
    rows = torch.arange(q.shape[0], device=q.device)
    kl[rows, :, slot] = k_new[:, 0].to(kl.dtype)
    vl[rows, :, slot] = v_new[:, 0].to(vl.dtype)
    o = ops.paged_decode_attention(q[:, 0], kl, vl, table, cache.pos[layer],
                                   step, window=window)
    return o[:, None]


def _write_ring_sharded(ring, new, slot: torch.Tensor) -> None:
    """One layer's ring ``ring`` (B, Hkv, W, hd), a DTensor, takes ``new``
    (B, Hkv, hd) at each of this rank's rows' ``slot`` (local, from
    :func:`write_ring_positions`), in place: each rank writes its own
    rows and, where the ring's width is split over ``model``, only the
    slots it holds (``new`` taken whole over ``model`` there)."""
    from torch.distributed.tensor import Replicate, Shard
    want = [Shard(0) if p == Shard(0) else
            Shard(1) if p == Shard(1) else Replicate()
            for p in ring.placements]
    new = sharded.redistribute(new, want).to_local()
    loc = ring.to_local()
    rows = torch.arange(loc.shape[0], device=loc.device)
    s = slot
    if Shard(2) in ring.placements:
        W = loc.shape[2]
        lo = sharded.model_rank(ring.device_mesh) * W
        held = (slot >= lo) & (slot < lo + W)
        s = (slot - lo).clamp(0, W - 1)
        new = torch.where(held[:, None, None], new.to(loc.dtype),
                          loc[rows, :, s])
    loc[rows, :, s] = new.to(loc.dtype)


def cross_decode_attention(q, cache: LayerCache, layer: int,
                           table: torch.Tensor) -> torch.Tensor:
    """One layer's decode cross-attention against its cross ring, which
    it reads and never writes: the projected memory K/V at positions
    0..W-1, W the ring's width (a ring from the prefill, or an empty one,
    every position -1).

    The reference decodes with step ``2**30`` and no ring eviction
    (``decode_attention`` applies ``pos > step - W`` only to a self ring's
    deferred write); the paged kernel always applies it, so at that step
    every position would be masked.  The step here is the largest memory
    position, W - 1: its mask ``W - 1 - W < pos <= W - 1`` keeps every
    position 0..W-1, the reference's token set.
    q: (B, 1, Hq, hd); ``table`` = arange(B)[:, None] int32.  Returns
    (B, 1, Hq, hd)."""
    W = cache.pos.shape[-1]
    step = torch.full((q.shape[0],), W - 1, dtype=torch.int32,
                      device=q.device)
    o = ops.paged_decode_attention(q[:, 0], cache.k[layer], cache.v[layer],
                                   table, cache.pos[layer], step)
    return o[:, None]


class PagedCache(NamedTuple):
    """Paged decode cache: one block pool shared by the slots, and a table
    of pool ids per slot (the JAX package's ``PagedCache``).

    k, v: (L, NB, Hkv, bs, hd).  Block 0 is the trash block: the writes of
    slots with no block for their position land there, and no table points
    at it.  pos: (NB, bs) int32 absolute positions, -1 = empty, shared by
    all layers.  table: (B, W // bs) int32 pool ids, -1 = unallocated."""
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    table: torch.Tensor


def empty_paged_cache(n_layers: int, num_blocks: int, slots: int,
                      n_kv_heads: int, width: int, block_size: int,
                      head_dim: int, dtype, device) -> PagedCache:
    """A zeroed pool with every position empty and every table entry
    unallocated.  ``width`` (each slot's ring) must be a block multiple."""
    if width % block_size != 0:
        raise ValueError(f"paged cache width {width} must be a multiple of "
                         f"block_size {block_size}")
    shape = (n_layers, num_blocks, n_kv_heads, block_size, head_dim)
    return PagedCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((num_blocks, block_size), -1, dtype=torch.int32,
                       device=device),
        table=torch.full((slots, width // block_size), -1, dtype=torch.int32,
                         device=device))


def write_paged_positions(cache: PagedCache, step: torch.Tensor):
    """Record each slot's new token position ``step`` (B,) in the pool's
    position plane, in place, once for all layers: at block
    ``table[b, (step % W) // bs]``, offset ``step % bs``, or in the trash
    block where that table entry is -1.  Returns the (B,) destination
    blocks and offsets for :func:`paged_decode_layer_attention`."""
    bs = cache.pos.shape[1]
    W = cache.table.shape[1] * bs
    s = step.long()
    blk = cache.table.gather(1, (torch.remainder(s, W) // bs)[:, None])[:, 0]
    dst = torch.where(blk >= 0, blk, torch.zeros_like(blk)).long()
    off = torch.remainder(s, bs)
    cache.pos[dst, off] = step.to(torch.int32)
    return dst, off


def paged_decode_layer_attention(q, k_new, v_new, cache: PagedCache,
                                 layer: int, dst: torch.Tensor,
                                 off: torch.Tensor,
                                 step: torch.Tensor,
                                 window: Optional[int] = None
                                 ) -> torch.Tensor:
    """One layer's decode attention against the pool: writes the new K/V at
    (``dst``, ``off``) from :func:`write_paged_positions`, in place, then
    attends through the paged decode kernel with the slots' tables (and
    the ``window``, where given).
    q: (B, 1, Hq, hd); k_new, v_new: (B, 1, Hkv, hd).  Returns
    (B, 1, Hq, hd)."""
    kl, vl = cache.k[layer], cache.v[layer]
    kl[dst, :, off] = k_new[:, 0].to(kl.dtype)
    vl[dst, :, off] = v_new[:, 0].to(vl.dtype)
    o = ops.paged_decode_attention(q[:, 0], kl, vl, cache.table, cache.pos,
                                   step, window=window)
    return o[:, None]


def gather_context(cache: PagedCache, ctx_ids: torch.Tensor):
    """The context of a chunk from the pool: blocks ``ctx_ids`` (B, C) in
    order (0 pads with the trash block) as k, v (L, B, C*bs, Hkv, hd) and
    their positions (B, C*bs).  The positions of padding are -1 whatever the
    pool holds: the trash block's position plane receives real positions
    from idle slots' discarded tick writes, so it is masked by
    ``ctx_ids > 0``, never read."""
    B, C = ctx_ids.shape
    bs = cache.pos.shape[1]
    safe = ctx_ids.clamp(min=0).long()

    def gather(pool):       # (L, NB, Hkv, bs, hd) -> (L, B, C*bs, Hkv, hd)
        g = pool[:, safe]   # (L, B, C, Hkv, bs, hd)
        L, _, _, Hkv, _, hd = g.shape
        return g.permute(0, 1, 2, 4, 3, 5).reshape(L, B, C * bs, Hkv, hd)
    pos = torch.where(ctx_ids[:, :, None] > 0, cache.pos[safe],
                      torch.full_like(cache.pos[safe], -1))
    return gather(cache.k), gather(cache.v), pos.reshape(B, C * bs)
