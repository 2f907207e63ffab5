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
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops


class LayerCache(NamedTuple):
    """Decode cache, stacked over layers by the model."""
    k: torch.Tensor       # (L, B, Hkv, W, hd)
    v: torch.Tensor       # (L, B, Hkv, W, hd)
    pos: torch.Tensor     # (L, B, W) int32 absolute positions, -1 = empty


def project_qkv(x: torch.Tensor, wq, wk, wv):
    """x (B, S, d) -> q (B, S, Hq, hd), k and v (B, S, Hkv, hd)."""
    dt = x.dtype
    B, S, d = x.shape
    q = (x @ wq.to(dt).reshape(d, -1)).view(B, S, wq.shape[1], wq.shape[2])
    k = (x @ wk.to(dt).reshape(d, -1)).view(B, S, wk.shape[1], wk.shape[2])
    v = (x @ wv.to(dt).reshape(d, -1)).view(B, S, wv.shape[1], wv.shape[2])
    return q, k, v


def output_projection(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """o (B, S, Hq, hd) -> (B, S, d)."""
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ wo.to(o.dtype).reshape(-1, wo.shape[-1])


def prefill_attention(q, k, v) -> torch.Tensor:
    """Causal self-attention over positions 0..S-1 (right padding sits at
    later positions, so index causality equals position causality).
    q: (B, S, Hq, hd), k, v: (B, S, Hkv, hd) -> (B, S, Hq, hd)."""
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True)
    return o.transpose(1, 2)


def suffix_attention(q, k, v, ctx_k, ctx_v, positions,
                     ctx_pos) -> torch.Tensor:
    """One layer's suffix-prefill attention (mode "suffix" of the JAX
    package's attention; Delphi takes no RoPE): the chunk's projected heads
    q (B, Sc, Hq, hd) and k, v (B, Sc, Hkv, hd) at ``positions`` (B, Sc)
    attend over the context ``ctx_k``/``ctx_v`` (B, C, Hkv, hd) at
    ``ctx_pos`` (B, C) followed by the chunk, causal by position (-1 =
    invalid).  Returns (B, Sc, Hq, hd); the caller keeps k and v for its
    block write."""
    return ops.suffix_prefill_attention(q, k, v, ctx_k, ctx_v, positions,
                                        ctx_pos, causal=True,
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


def write_ring_positions(cache: LayerCache, step: torch.Tensor) -> torch.Tensor:
    """Record each slot's new token position ``step`` (B,) at ring slot
    ``step % W`` of every layer's position plane, in place.  Returns the
    (B,) ring slots."""
    W = cache.pos.shape[-1]
    slot = torch.remainder(step.long(), W)
    rows = torch.arange(step.shape[0], device=step.device)
    cache.pos[:, rows, slot] = step.to(torch.int32)
    return slot


def ring_decode_attention(q, k_new, v_new, cache: LayerCache, layer: int,
                          slot: torch.Tensor, step: torch.Tensor,
                          table: torch.Tensor) -> torch.Tensor:
    """One layer's decode attention against its ring.

    q: (B, 1, Hq, hd); k_new, v_new: (B, 1, Hkv, hd); ``slot`` (B,) from
    :func:`write_ring_positions`; ``table`` = arange(B)[:, None] int32.
    Writes the new K/V into the layer's ring in place, then attends through
    the paged decode kernel.  Returns (B, 1, Hq, hd)."""
    kl, vl = cache.k[layer], cache.v[layer]
    rows = torch.arange(q.shape[0], device=q.device)
    kl[rows, :, slot] = k_new[:, 0].to(kl.dtype)
    vl[rows, :, slot] = v_new[:, 0].to(vl.dtype)
    o = ops.paged_decode_attention(q[:, 0], kl, vl, table, cache.pos[layer],
                                   step)
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
                                 step: torch.Tensor) -> torch.Tensor:
    """One layer's decode attention against the pool: writes the new K/V at
    (``dst``, ``off``) from :func:`write_paged_positions`, in place, then
    attends through the paged decode kernel with the slots' tables.
    q: (B, 1, Hq, hd); k_new, v_new: (B, 1, Hkv, hd).  Returns
    (B, 1, Hq, hd)."""
    kl, vl = cache.k[layer], cache.v[layer]
    kl[dst, :, off] = k_new[:, 0].to(kl.dtype)
    vl[dst, :, off] = v_new[:, 0].to(vl.dtype)
    o = ops.paged_decode_attention(q[:, 0], kl, vl, cache.table, cache.pos,
                                   step)
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
