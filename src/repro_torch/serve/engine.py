"""Batched serving engine: device-resident continuous batching over a
per-slot ring KV cache or a paged block pool (the JAX package's
``serve/engine.py``), for Delphi and for generic LMs (Mamba2).

* Each tick runs ONE batched ``decode_step`` over all slots, each at its own
  absolute position, then samples, then ``advance_trajectory_state``
  (:func:`_tick_core`).  Delphi samples eq. 1 (``sample_next_event``: the
  ``tte_sample`` CUDA kernel on the card); a generic LM samples by
  Gumbel-argmax, ``argmax(logits / temperature + g)``, with no age and no
  Death token.  Slot state (last token, age, step, emitted count, budget,
  active) stays on the device.
* The host sees exactly ONE packed (4, slots) device->host copy per tick and
  one per admission batch (a fork wave is one), counted in ``host_syncs``.
  Nothing else reads device values on the host: the paged scheduler works
  on host mirrors (block tables, refcounts, each slot's next position), and
  table uploads are host->device copies.
* Admission of an attention model runs a bucketed-padding batched prefill
  (:func:`_prefill_core`): prompt lengths are right-padded to power-of-two
  buckets and admission groups to power-of-two batch buckets, the prefill
  builds rings of width ``max_context``, padded positions are invalidated
  (``mask_padded_positions``) and the rows are inserted into the slot ring
  or copied into pool blocks.  Recurrent state (SSM) cannot mask padding,
  so such a model admits each prompt solo at its exact length.
* ``cache="paged"``: a shared pool of ``block_size``-token blocks with a
  table per slot.  Admission is budgeted by free blocks, decode grows a
  slot a block at a time, a write into a block shared with another owner
  copies it first (copy-on-write), and pool exhaustion preempts the
  youngest request, which is requeued and resumes by re-prefilling its
  prompt and the events it had emitted.  ``prefix_cache=True`` indexes
  admitted prompts (``serve.prefix``) so that a request with an indexed
  history shares its blocks by reference.  Under injected uniforms the
  paged engine's trajectories equal the ring engine's bit for bit.
* ``hold``/``fork``/``sample_futures``: a held request is prefilled and
  parked; ``fork`` clones it into N decode slots that share its blocks
  (paged) or copy its ring row (ring), each sampling its own first event
  from the parent's prefill logits (:func:`_fork_rows_core`).  A recurrent
  model's parent keeps its state as admitted, which the fork copies: the
  batched tick advances every row's state, a parked one's too.
* ``prefill_chunk_tokens`` (paged only): chunked prefill.  Admission
  stages a prompt (its blocks allocated, any indexed prefix shared by
  reference) and the prompt's unmatched suffix is prefilled between decode
  ticks, at most ``prefill_chunk_tokens`` tokens a step over all staged
  prompts, oldest first (:func:`_suffix_chunk_core`: the chunk attends over
  its context blocks gathered from the pool, by position).  So a long
  prompt no longer stalls the slots that decode, and a prompt that extends
  an indexed prefix prefills only its suffix.  The final chunk's logits
  bootstrap the first event (one host copy, like any admission batch); a
  chunk before it makes none.
* Uniforms are injected per request (rows of inactive slots are 0.5) or
  drawn from a ``torch.Generator`` on the device.

The decode writes each new token into the cache before the layer attends
(``models.attention``), so everything a tick's write depends on is issued
on the tick's stream before it: copy-on-write copies, the position reset
of freshly allocated blocks and the table upload (``_ensure_blocks``,
``_flush_slot_updates``).  A held slot still rides the batched tick: its
table column for the write is -1 in the device copy, so the discarded write
lands in the trash block.  A slot whose prompt is still chunking rides it
too, inactive, with its whole table row -1 in the device copy until its
last chunk lands: nothing reads or writes its half-written blocks.

Foreground (``step``/``run`` on the caller's thread) or background
(``start``: a daemon thread ticks, with exponential idle backoff, and
``submit``/``cancel``/``fork`` wake it).  Per-request hooks fire on the
loop's thread: ``on_event`` on the host side of the tick's one sync,
``on_done`` once when the request ends, after ``error`` is set.  A tick
that raises fails every queued, parked and in-flight request with that
exception, frees their blocks, and the loop goes on serving.  Every thread
launches on its own current stream, which is the default stream: the
engine creates no side stream.  Cancelled, expired and malformed requests
end with ``repro_torch.api.errors`` classes, which carry wire codes.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api.errors import (InvalidRequestError,
                                    RequestCancelledError,
                                    RequestTimeoutError)
from repro_torch.configs import base as cb
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sampler import (advance_trajectory_state,
                                      sample_next_event)
from repro_torch.models import (cast_params, decode_step, forward,
                                forward_suffix, make_decode_cache,
                                make_paged_decode_cache,
                                mask_padded_positions)
from repro_torch.models.attention import gather_context
from repro_torch.serve.prefix import PrefixIndex, SharedBlockPool


def _to_host(x: torch.Tensor) -> np.ndarray:
    """The engine's only device->host copy (tests count calls to it)."""
    return x.cpu().numpy()


@dataclasses.dataclass(eq=False)        # identity, not ndarray comparison
class Request:
    tokens: np.ndarray                  # (S,) prompt
    ages: Optional[np.ndarray] = None   # (S,) event ages in years (Delphi)
    max_new: int = 64
    # optional pre-drawn U(0,1) of shape (max_new, V): row i is consumed by
    # the i-th sampled event (row 0 at admission, from the prefill logits;
    # a preempted request resumes on row len(out_tokens))
    uniforms: Optional[np.ndarray] = None
    # hooks, called on the thread that ticks: on_event(token, age or None)
    # per emitted event, on the host side of the tick's sync; on_done(req)
    # once when the request ends, after ``error`` is set
    on_event: Optional[Callable[[int, Optional[float]], None]] = None
    on_done: Optional[Callable[["Request"], None]] = None
    request_id: Optional[str] = None    # autogenerated at submit when unset
    # prefill-only parking: the request is admitted (prompt KV in the cache,
    # bootstrap logits kept) but samples nothing and holds its slot until
    # ``BatchedEngine.fork`` clones it into N decode slots
    hold: bool = False
    # filled by the engine:
    out_tokens: Optional[List[int]] = None
    out_ages: Optional[List[float]] = None   # Delphi only; empty otherwise
    done: bool = False
    error: Optional[BaseException] = None
    # admission order (preemption takes the youngest) and the deadline
    # stamped at submit when the engine enforces request timeouts
    _seq: int = dataclasses.field(default=0, repr=False)
    _deadline: Optional[float] = dataclasses.field(default=None, repr=False)
    # memoized prefix-index digests of the effective prompt, keyed by its
    # length (it grows when a preempted request resumes)
    _pfx: Optional[tuple] = dataclasses.field(default=None, repr=False)


@dataclasses.dataclass(eq=False)
class _PrefillProgress:
    """Host state of one chunked prefill in progress.  While a slot is
    here its device table row stays -1: the tick's discarded write goes to
    the trash block and nothing reads its half-written blocks.  ``cursor``
    counts the prompt tokens already in the pool; it starts at the matched
    prefix (full blocks lent by the index), so only the suffix is
    computed."""
    req: Request
    tokens: np.ndarray                  # effective prompt (history + resumed)
    ages: Optional[np.ndarray]
    max_new: int                        # remaining budget after a resume
    age0: float
    S: int                              # effective prompt length
    cursor: int                         # block-aligned, or S when done


class BlockAllocator:
    """Host-side free list over the paged pool.

    Block 0 is the trash block: the destination of the writes of slots with
    no block for their position, never handed out.  ``used`` returns to 0
    whenever the engine drains (the zero-leak invariant)."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("paged pool needs >= 2 blocks "
                             "(block 0 is the reserved trash block)")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))
        self.peak_used = 0

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return self.capacity - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n block ids, or None (never partial) when the pool can't serve."""
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        self.peak_used = max(self.peak_used, self.used)
        return ids

    def release(self, ids: List[int]) -> None:
        for i in ids:
            if not 0 < i < self.num_blocks:
                raise ValueError(f"release of invalid block id {i}")
        self._free.extend(ids)
        if len(self._free) > self.capacity:
            raise RuntimeError("double free in the paged block allocator")


MIN_SEQ_BUCKET = 8       # smallest padded prompt width of a prefill


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length() if n > 1 else 1


def _seq_bucket(n: int) -> int:
    return max(_next_pow2(n), MIN_SEQ_BUCKET)


# ---------------------------------------------------------------------------
# Device math of a tick, an admission and a fork.  Module-level, so that the
# fork oracle (``serve.prefix.ring_reference_futures``) runs the same code.
# ---------------------------------------------------------------------------
class _Knobs(NamedTuple):
    """The engine's static sampling and termination parameters."""
    slots: int
    max_context: int
    is_delphi: bool
    inv_temp: float
    max_age: float
    death_token: int
    vocab: int

    @classmethod
    def of(cls, cfg: ModelConfig, slots: int, max_context: int,
           temperature: float) -> "_Knobs":
        return cls(slots=slots, max_context=max_context,
                   is_delphi=cfg.age_encoding,
                   inv_temp=1.0 / max(temperature, 1e-6),
                   max_age=cfg.max_age, death_token=cfg.death_token,
                   vocab=cfg.vocab_size)


def gumbel_sample(lg: torch.Tensor, u: torch.Tensor, inv_temp: float):
    """Generic-LM sampling: ``argmax(lg * inv_temp + g)`` with Gumbel noise
    ``g = -log(-log(clip(u, 1e-12, 1 - 1e-12)))`` from the uniforms.
    Returns (token (B,) int32, zero waiting times (B,) fp32)."""
    g = -torch.log(-torch.log(u.float().clamp(1e-12, 1.0 - 1e-12)))
    evt = torch.argmax(lg * inv_temp + g, dim=-1).to(torch.int32)
    return evt, torch.zeros(evt.shape, dtype=torch.float32, device=lg.device)


def _advance(lg, u, age, n_emitted, max_new, next_pos, active, kn: _Knobs):
    if kn.is_delphi:
        evt, tmin = sample_next_event(lg, u)
    else:
        evt, tmin = gumbel_sample(lg, u, kn.inv_temp)
    return advance_trajectory_state(
        evt, tmin, age, n_emitted, max_new, next_pos, active,
        max_age=kn.max_age if kn.is_delphi else float("inf"),
        death_token=kn.death_token if kn.is_delphi else -1,
        max_context=kn.max_context)


def _pack(adv) -> torch.Tensor:
    return torch.stack([adv["evt"].float(), adv["age"],
                        adv["emit"].float(), adv["finished"].float()])


def _tick_core(params, cache, state, u, cfg: ModelConfig, kn: _Knobs):
    """One decode tick over every slot: the cache is updated in place.
    Returns (new state, packed (4, slots))."""
    batch = {"tokens": state["last"][:, None]}
    if cfg.age_encoding:
        batch["ages"] = state["age"][:, None]
    d = decode_step(params, cfg, cache, batch, state["step"])
    lg = d["logits"][:, 0]
    next_step = torch.where(state["active"], state["step"] + 1, state["step"])
    adv = _advance(lg, u, state["age"], state["n_emitted"], state["max_new"],
                   next_step, state["active"], kn)
    new_state = {
        "last": torch.where(adv["emit"], adv["evt"], state["last"]),
        "age": adv["age"],
        "step": next_step,
        "n_emitted": adv["n_emitted"],
        "max_new": state["max_new"],
        "active": state["active"] & ~adv["finished"],
    }
    return new_state, _pack(adv)


def _prefill_core(params, tokens, ages, last_idx, age0, lengths, max_new, u,
                  cfg: ModelConfig, kn: _Knobs):
    """Batched prefill of right-padded prompts and each row's first event
    from the logits at its last token.  Returns (cache rows, slot-state
    rows, packed (4, nb), the (nb, V) fp32 bootstrap logits)."""
    batch = {"tokens": tokens}
    if cfg.age_encoding:
        batch["ages"] = ages
    out = forward(params, cfg, batch, mode="prefill",
                  cache_width=kn.max_context, last_index=last_idx)
    cache_rows = mask_padded_positions(out["cache"], last_idx)
    lg = out["logits"][:, 0]
    rows, packed = _fork_rows_core(lg, u, age0, lengths, max_new, kn)
    return cache_rows, rows, packed, lg


def _fork_rows_core(lg, u, age0, lengths, max_new, kn: _Knobs):
    """Slot-state rows of rows that sample their FIRST event from logits
    ``lg`` (nb, V): the tail of :func:`_prefill_core`, and forked futures
    from their parent's prefill logits.  Returns (rows, packed (4, nb))."""
    nb = u.shape[0]
    active = torch.ones((nb,), dtype=torch.bool, device=u.device)
    adv = _advance(lg, u, age0,
                   torch.zeros((nb,), dtype=torch.int32, device=u.device),
                   max_new, lengths, active, kn)
    rows = {
        "last": torch.where(adv["emit"], adv["evt"],
                            torch.zeros_like(adv["evt"])),
        "age": adv["age"],
        "step": lengths,
        "n_emitted": adv["n_emitted"],
        "max_new": max_new,
        "active": active & ~adv["finished"],
    }
    return rows, _pack(adv)


def _commit(state, ids: torch.Tensor, rows, n: int) -> None:
    """Write the first ``n`` slot-state rows at slots ``ids``, in place."""
    for key, val in rows.items():
        state[key][ids] = val[:n].to(state[key].dtype)


def _insert_rows(cache, rows, ids: torch.Tensor, n: int) -> None:
    """Write the first ``n`` prefill rows of every cache leaf into the slot
    cache at slots ``ids`` (leaves are (L, slots, ...)), in place."""
    for kind, big in cache.items():
        for buf, new in zip(big, rows[kind]):
            buf[:, ids] = new[:, :n].to(buf.dtype)


def _fork_copy_rows(cache, src: int, dst: List[int], max_pos: int) -> None:
    """Ring fork: copy slot ``src``'s cache row into slots ``dst``, in
    place.  Ring positions past ``max_pos`` (the prompt's last index) are
    invalidated in the copies: a held parent's parked ticks wrote a
    discarded token at its next position."""
    for kind, c in cache.items():
        ids = torch.tensor(dst, dtype=torch.long, device=c[0].device)
        for buf in c:
            row = buf[:, src:src + 1].clone()
            if kind == "self" and buf is c.pos:
                row = torch.where((row >= 0) & (row <= max_pos), row,
                                  torch.full_like(row, -1))
            buf[:, ids] = row


def _cow_block(cache, src: int, dst: int) -> None:
    """Copy-on-write: duplicate pool block ``src`` (K/V of every layer and
    its positions) into ``dst`` before a slot writes into it."""
    pc = cache["self"]
    pc.k[:, dst].copy_(pc.k[:, src])
    pc.v[:, dst].copy_(pc.v[:, src])
    pc.pos[dst].copy_(pc.pos[src])


def _insert_blocks(cache, rows_cache, dst: torch.Tensor, n: int,
                   nblk: int) -> None:
    """Copy-on-admit: the first ``nblk`` blocks of the first ``n`` prefill
    ring rows (L, ., Hkv, W, hd) go to pool ids ``dst`` (n, nblk).  The
    blocks a row does not need point at the trash block 0.  Positions are
    the same in every layer's ring, so layer 0's are copied."""
    pc = cache["self"]
    rows = rows_cache["self"]
    bs = pc.k.shape[3]
    d = dst.reshape(-1)

    def blocks(a):          # (L, n, Hkv, W, hd) -> (L, n*nblk, Hkv, bs, hd)
        L, _, Hkv, _, hd = a.shape
        a = a[:, :n, :, :nblk * bs].reshape(L, n, Hkv, nblk, bs, hd)
        return a.permute(0, 1, 3, 2, 4, 5).reshape(L, n * nblk, Hkv, bs, hd)
    pc.k[:, d] = blocks(rows.k).to(pc.k.dtype)
    pc.v[:, d] = blocks(rows.v).to(pc.v.dtype)
    pc.pos[d] = rows.pos[0, :n, :nblk * bs].reshape(n * nblk, bs)


def _chunk_len(S: int, cursor: int, budget: int, bs: int) -> int:
    """Tokens the budget scheduler prefills next for one slot: the whole
    remaining suffix when it fits the budget, otherwise the largest
    block-aligned chunk the budget covers (chunk boundaries stay on block
    edges so every chunk scatter writes whole pool blocks)."""
    n = min(budget, S - cursor)
    if cursor + n < S:
        n = (n // bs) * bs
    return n


def _chunk_arrays(toks, ags, start: int, n: int, bs: int, table_row):
    """Bucketed host arrays for ONE suffix-prefill chunk.

    Shared by the engine tick and the straight-line oracle
    (``repro_torch.serve.prefix.chunked_reference_trajectory``): identical
    shapes mean identical arithmetic, which is what makes chunked engine
    trajectories bit-equal to the oracle's.  ``start`` is block-aligned
    (chunks advance in whole blocks; only the final chunk may end
    unaligned).  Token/position tails past ``n`` pad with pos = -1 (masked
    everywhere), context ids pad with the trash block 0.
    """
    nblk = -(-n // bs)
    nblk_pad = _next_pow2(nblk)
    sc = nblk_pad * bs
    tokens = np.zeros((1, sc), np.int32)
    tokens[0, :n] = toks[start:start + n]
    ages = np.zeros((1, sc), np.float32)
    if ags is not None:
        ages[0, :n] = ags[start:start + n]
        ages[0, n:] = ags[start + n - 1]
    positions = np.full((1, sc), -1, np.int32)
    positions[0, :n] = np.arange(start, start + n, dtype=np.int32)
    # a chunk starting at the prompt head carries a zero-width context:
    # beyond saving work, identical KV widths keep the budget-infinity
    # chunk bit-identical to the monolithic prefill (a masked-out pad
    # block would reassociate the softmax reductions)
    first = start // bs
    nctx = _next_pow2(first) if first else 0
    ctx_ids = np.zeros((1, nctx), np.int32)
    ctx_ids[0, :first] = table_row[:first]
    dst = np.zeros((1, nblk_pad), np.int32)
    dst[0, :nblk] = table_row[first:first + nblk]
    last_idx = np.asarray([n - 1], np.int32)
    return tokens, ages, positions, ctx_ids, dst, last_idx


def _chunk_width(n: int, sc: int, max_context: int) -> int:
    """Columns of an ``sc``-wide chunk of ``n`` tokens that the forward
    computes: the monolithic prefill's bucket where it is narrower (a chunk
    shorter than a block), so that a whole prompt in one chunk runs every
    product at the monolithic prefill's shapes and gives its bits."""
    return min(sc, _seq_bucket(n), max_context)


def _suffix_chunk_core(params, cache, tokens, ages, positions, ctx_ids, dst,
                       last_idx, cfg: ModelConfig,
                       width: Optional[int] = None) -> torch.Tensor:
    """One chunked-prefill step, the pool updated in place: gather the
    slot's context blocks ``ctx_ids`` (B, C) (0 = trash padding, its
    positions masked), run :func:`forward_suffix` over the first ``width``
    (default all) chunk columns (tokens/ages/positions (B, Sc), pos -1 =
    padding), then write the chunk's K/V (zeros past ``width``) and its
    full position planes into blocks ``dst`` (B, nblk) (0 = trash
    padding): the padded tail of a partial final block carries -1, so a
    block's previous positions never leak.  Returns the (B, V) fp32 logits
    at ``last_idx``: the final chunk's bootstrap logits."""
    pc = cache["self"]
    bs = pc.k.shape[3]
    B, Sc = tokens.shape
    w = Sc if width is None else width
    ck, cv, cpos = gather_context(pc, ctx_ids)
    batch = {"tokens": tokens[:, :w], "positions": positions[:, :w]}
    if cfg.age_encoding:
        batch["ages"] = ages[:, :w]
    out = forward_suffix(params, cfg, batch, {"k": ck, "v": cv, "pos": cpos},
                         last_index=last_idx)
    nblk = Sc // bs
    d = dst.reshape(-1).long()

    def blocks(a):          # (L, B, w, Hkv, hd) -> (L, B*nblk, Hkv, bs, hd)
        L, _, _, Hkv, hd = a.shape
        if w < Sc:
            a = torch.cat([a, a.new_zeros((L, B, Sc - w, Hkv, hd))], dim=2)
        a = a.reshape(L, B, nblk, bs, Hkv, hd).permute(0, 1, 2, 4, 3, 5)
        return a.reshape(L, B * nblk, Hkv, bs, hd)
    pc.k[:, d] = blocks(out["k"]).to(pc.k.dtype)
    pc.v[:, d] = blocks(out["v"]).to(pc.v.dtype)
    pc.pos[d] = positions.reshape(B * nblk, bs).to(torch.int32)
    return out["logits"][:, 0].float()


def _reset_pos(cache, ids: List[int]) -> None:
    """Invalidate the positions of freshly allocated growth blocks: a reused
    block still holds its previous owner's, which would read as valid
    context for the new slot."""
    pc = cache["self"]
    pc.pos[torch.tensor(ids, dtype=torch.long, device=pc.pos.device)] = -1


class BatchedEngine:
    """Slot-based continuous batching over a per-slot decode cache (a ring
    KV cache, a paged block pool, or a Mamba2 model's SSM state).

    ``params`` are the fp32 flat parameters (``models.params``); they move
    to ``device`` (``cuda`` unless the caller passes another), and the
    matrix-product weights are cast once to ``cfg.dtype`` for compute.
    ``temperature`` scales a generic LM's logits (Delphi ignores it).
    ``cache="paged"`` takes ``blocks`` (default: the ring's bytes,
    ``slots * max_context / block_size + 1`` with the trash block),
    ``block_size``, ``prefix_cache`` and ``prefill_chunk_tokens`` (the
    per-step token budget of chunked prefill, a multiple of
    ``block_size``; None prefills each admission whole).
    """

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 8,
                 max_context: int = 512, temperature: float = 1.0,
                 seed: int = 0, cache: str = "ring",
                 blocks: Optional[int] = None, block_size: int = 16,
                 request_timeout: Optional[float] = None,
                 prefix_cache: bool = False,
                 prefill_chunk_tokens: Optional[int] = None,
                 device="cuda"):
        if cache not in ("ring", "paged"):
            raise ValueError(f"cache must be 'ring' or 'paged': {cache!r}")
        if prefill_chunk_tokens is not None:
            if cache != "paged":
                raise ValueError(
                    "prefill_chunk_tokens requires the paged KV cache: "
                    "chunked prefill writes prompt KV through the paged "
                    "insert path — build with cache='paged'")
            if (prefill_chunk_tokens < block_size
                    or prefill_chunk_tokens % block_size != 0):
                raise ValueError(
                    f"prefill_chunk_tokens={prefill_chunk_tokens} must be a "
                    f"positive multiple of block_size={block_size}")
        self.prefill_chunk_tokens = prefill_chunk_tokens
        if prefix_cache and cache != "paged":
            raise ValueError(
                "prefix_cache requires the paged KV cache: the ring layout "
                "has no shareable blocks — build with cache='paged'")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.slots = slots
        self.max_context = max_context
        self.is_delphi = cfg.age_encoding
        # right-padding a prefill is sound only where padded positions can
        # be masked out of the state: KV-cache attention (pos = -1), not
        # recurrent SSM state, which admits unbucketed
        self.bucketed = cfg.arch_type in (cb.DENSE, cb.MOE, cb.VLM)
        self.paged = cache == "paged"
        self.block_size = block_size
        if self.paged:
            if not self.bucketed:
                raise ValueError("paged KV cache needs an attention-cache "
                                 "architecture (dense/moe/vlm)")
            if max_context % block_size != 0:
                raise ValueError(f"max_context={max_context} must be a "
                                 f"multiple of block_size={block_size}")
            self.blocks_per_slot = max_context // block_size
            if blocks is None:
                # dense-equivalent pool: the ring's bytes
                blocks = slots * self.blocks_per_slot + 1
            if blocks < self.blocks_per_slot + 1:
                raise ValueError(
                    f"pool of {blocks} blocks cannot hold one full slot "
                    f"(needs >= {self.blocks_per_slot + 1} including the "
                    f"trash block)")
        self.request_timeout = request_timeout
        self._kn = _Knobs.of(cfg, slots, max_context, temperature)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self._wparams = cast_params(self.params, cfg)
        if self.paged:
            self.allocator: Optional[BlockAllocator] = BlockAllocator(blocks)
            self.pool: Optional[SharedBlockPool] = \
                SharedBlockPool(self.allocator)
            self.prefix: Optional[PrefixIndex] = (
                PrefixIndex(self.pool, block_size) if prefix_cache else None)
            self.cache = make_paged_decode_cache(
                self._wparams, cfg, slots, max_context, num_blocks=blocks,
                block_size=block_size)
            self._table = np.full((slots, self.blocks_per_slot), -1, np.int32)
            self._table_dirty = False
            self._fresh_blocks: List[int] = []
            self._slot_blocks: List[List[int]] = [[] for _ in range(slots)]
        else:
            self.allocator = None
            self.pool = None
            self.prefix = None
            self.cache = make_decode_cache(self._wparams, cfg, slots,
                                           max_context)
        # host mirror of each slot's next decode-write position (the paged
        # scheduler allocates that block BEFORE the tick writes it)
        self._slot_pos = np.zeros(slots, np.int64)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        dev = self.device
        self._state: Dict[str, torch.Tensor] = {
            "last": torch.zeros((slots,), dtype=torch.int32, device=dev),
            "age": torch.zeros((slots,), dtype=torch.float32, device=dev),
            "step": torch.zeros((slots,), dtype=torch.int32, device=dev),
            "n_emitted": torch.zeros((slots,), dtype=torch.int32, device=dev),
            "max_new": torch.ones((slots,), dtype=torch.int32, device=dev),
            "active": torch.zeros((slots,), dtype=torch.bool, device=dev),
        }
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.pending: List[Request] = []               # guarded-by: _lock
        self.completed: List[Request] = []
        self._by_id: Dict[str, Request] = {}           # guarded-by: _lock
        self._cancel_ids: set = set()                  # guarded-by: _lock
        # queued fork ops (parent, children), applied between ticks
        self._fork_ops: List[Tuple[Request, List[Request]]] = []  # _lock
        self._deactivate: List[int] = []
        # slot -> (V,) bootstrap logits of a parked (held) parent
        self._held_logits: Dict[int, torch.Tensor] = {}
        # slot -> a parked parent's recurrent state after its prompt: the
        # batched tick advances every row's SSM state, so the fork copies
        # this, not the row the parked ticks went on updating
        self._held_state: Dict[int, dict] = {}
        # chunked prefill: slot -> its prompt's progress; such a slot holds
        # a table row but does not tick until its last chunk lands
        self._prefills: Dict[int, _PrefillProgress] = {}
        self._seq_counter = itertools.count(1)
        self._lock = threading.Lock()
        # background loop: ``_wake`` cuts the idle backoff short on new work;
        # with retain_completed False (start()'s default) finished requests
        # are seen only through their hooks
        self.retain_completed = True
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stop_flag = False
        # instrumentation (asserted on by tests and chip_smoke.py)
        self.ticks = 0
        self.host_syncs = 0
        self.admit_batches = 0
        self.preemptions = 0
        self.peak_active = 0
        self.forks = 0
        self.chunked_prefills = 0
        self.prefill_chunks = 0
        self.suffix_tokens_saved = 0
        self.prefill_shapes: set = set()

    # -- device->host boundary (the only one) -------------------------------
    def _fetch(self, x: torch.Tensor) -> np.ndarray:
        self.host_syncs += 1
        return _to_host(x)

    def _dev(self, x) -> torch.Tensor:
        """A host array as a tensor on the engine's device (host->device)."""
        return torch.from_numpy(np.asarray(x)).to(self.device)

    # -- public API ----------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Thread-safe enqueue."""
        if len(req.tokens) == 0:
            raise ValueError("empty prompt")
        if self.is_delphi and req.ages is None:
            raise ValueError("Delphi requests need ages")
        req.out_tokens, req.out_ages = [], []
        req._seq = next(self._seq_counter)
        if req.request_id is None:
            req.request_id = f"req-{id(self):x}-{req._seq}"
        if self.request_timeout is not None and req._deadline is None:
            req._deadline = time.monotonic() + self.request_timeout
        with self._lock:
            if req.request_id in self._by_id:
                raise InvalidRequestError(
                    f"request_id {req.request_id!r} is already in flight "
                    f"on this engine")
            self._by_id[req.request_id] = req
            self.pending.append(req)
        self._wake.set()

    def cancel(self, request_id: str) -> bool:
        """Flag a pending, parked or in-flight request (or a fork child not
        yet landed) for cancellation; the next tick drops it, frees its
        blocks, and it finishes with ``RequestCancelledError``.  Returns
        False for unknown or finished ids."""
        with self._lock:
            req = self._by_id.get(request_id)
            if req is None or req.done:
                return False
            self._cancel_ids.add(request_id)
        self._wake.set()
        return True

    # -- fork: the Monte-Carlo futures primitive ------------------------------
    def fork(self, request_id: str, n: Optional[int] = None, *,
             uniforms=None, max_new: Optional[int] = None,
             children: Optional[List[Request]] = None) -> List[Request]:
        """Clone a held (``Request.hold=True``) parent into N decode slots.
        The op is queued and applied between ticks.

        Each child shares all of the parent's blocks by reference (paged:
        refcounts, the first write into the shared tail block copies it;
        ring: one row copy with positions past the prompt masked) and
        samples its OWN first event from the parent's prefill logits.
        Children beyond the free slots queue as pending requests (they
        re-acquire the prefix through the index when it is on).  The parent
        is consumed.  Pass ``children`` or ``n`` [+ per-child ``uniforms``
        (n, max_new, V)]; returns the child requests."""
        with self._lock:
            parent = self._by_id.get(request_id)
        if parent is None or parent.done:
            raise InvalidRequestError(
                f"fork of unknown or finished request {request_id!r}")
        if not parent.hold:
            raise InvalidRequestError(
                "fork requires a hold=True parent (prefill-only parked "
                "request): submit(Request(..., hold=True)) first")
        if children is None:
            children = self._build_fork_children(parent, n, uniforms,
                                                 max_new)
        if not children:
            raise InvalidRequestError("fork of zero children")
        injected = children[0].uniforms is not None
        if any((c.uniforms is not None) != injected for c in children):
            raise InvalidRequestError(
                "fork children must be uniformly injected or uniformly "
                "generator-sampled (one tick draws from one uniform source)")
        for c in children:
            c.out_tokens, c.out_ages = [], []
            c._seq = next(self._seq_counter)
            if c.request_id is None:
                c.request_id = f"req-{id(self):x}-{c._seq}"
            if self.request_timeout is not None and c._deadline is None:
                c._deadline = time.monotonic() + self.request_timeout
        with self._lock:
            # validate every id before registering any
            ids = [c.request_id for c in children]
            clashes = [i for i in ids if i in self._by_id]
            if clashes or len(set(ids)) != len(ids):
                raise InvalidRequestError(
                    f"fork child request_id(s) already in flight or "
                    f"duplicated: {clashes or ids!r}")
            for c in children:
                self._by_id[c.request_id] = c
            self._fork_ops.append((parent, list(children)))
        self._wake.set()
        return children

    def _build_fork_children(self, parent: Request, n: Optional[int],
                             uniforms, max_new: Optional[int]
                             ) -> List[Request]:
        """The one construction of fork children (``fork`` and
        ``sample_futures``): shapes are checked before any state changes."""
        if n is None or n < 1:
            raise InvalidRequestError("fork needs n >= 1 or children=[...]")
        mn = parent.max_new if max_new is None else max_new
        if uniforms is not None:
            uniforms = np.asarray(uniforms)
            if uniforms.ndim != 3 or uniforms.shape[0] < n:
                raise InvalidRequestError(
                    f"fork uniforms must be (>= n, max_new, V); got "
                    f"{tuple(uniforms.shape)}")
        return [
            Request(tokens=np.asarray(parent.tokens),
                    ages=(np.asarray(parent.ages)
                          if parent.ages is not None else None),
                    max_new=mn,
                    uniforms=(None if uniforms is None
                              else np.asarray(uniforms[i])),
                    request_id=f"{parent.request_id}/fork-{i}")
            for i in range(n)]

    def sample_futures(self, tokens, ages=None, *, n: int,
                       max_new: int = 48, uniforms=None,
                       request_id: Optional[str] = None,
                       wait_timeout: float = 300.0) -> List[Request]:
        """N stochastic futures of one history through hold + fork: submit
        a held parent, fork it into ``n`` children sharing its KV, and run
        the engine in the foreground until everything submitted finishes,
        or, when the background loop runs, wait on the children's
        ``on_done`` (``RequestTimeoutError`` after ``wait_timeout``
        seconds).  Returns the child requests in fork order; check
        ``Request.error`` per child."""
        parent = Request(tokens=np.asarray(tokens),
                         ages=(np.asarray(ages) if ages is not None
                               else None),
                         max_new=max_new, hold=True, request_id=request_id)
        running = self.running
        # check the children's shapes before the parent parks in a slot;
        # with an autogenerated parent id, rebuild them from the real id.
        # Hooks go on before the fork: the loop may apply it at once
        children = self._build_fork_children(parent, n, uniforms, max_new)
        self.submit(parent)
        if request_id is None:
            children = self._build_fork_children(parent, n, uniforms,
                                                 max_new)
        waits: List[threading.Event] = []
        if running:
            for c in children:
                evt = threading.Event()
                c.on_done = lambda _r, _evt=evt: _evt.set()
                waits.append(evt)
        self.fork(parent.request_id, children=children)
        if running:
            for evt in waits:
                if not evt.wait(wait_timeout):
                    raise RequestTimeoutError(
                        f"engine did not complete the forked futures within "
                        f"{wait_timeout}s")
        else:
            self.run()
        return children

    def drop_prefix_cache(self) -> int:
        """Evict every prefix-index entry; returns the blocks freed.  On a
        drained engine this restores ``allocator.used == 0``.  The index
        and the refcounts belong to the thread that ticks, so this refuses
        while the background loop runs: ``stop()`` first."""
        if self.prefix is None:
            return 0
        if self.running:
            raise RuntimeError(
                "drop_prefix_cache() mutates engine-thread state (index + "
                "refcounts): stop() the background loop first")
        return self.prefix.clear()

    # -- background loop ------------------------------------------------------
    def start(self, *, idle_min: float = 0.001, idle_max: float = 0.05,
              retain_completed: bool = False) -> "BatchedEngine":
        """Tick on a daemon thread until :meth:`stop`.  With no work the
        loop waits from ``idle_min`` doubling up to ``idle_max`` seconds
        between polls; ``submit``, ``cancel`` and ``fork`` wake it at once.
        ``retain_completed=False`` keeps ``completed`` empty (a long-running
        server would otherwise keep every finished request): completion is
        seen through ``on_event``/``on_done``."""
        if self.running:
            return self
        self.retain_completed = retain_completed
        self._stop_flag = False
        self._wake.clear()
        self._thread = threading.Thread(
            target=self._loop, args=(idle_min, idle_max),
            name="repro-torch-engine-loop", daemon=True)
        self._thread.start()
        return self

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stop(self, join: bool = True, timeout: float = 60.0) -> None:
        """End the background loop.  Requests still queued or in flight
        fail at once ("engine stopped with the request in flight"), so
        their waiters never sit out a timeout."""
        was_running = self.running
        self._stop_flag = True
        self._wake.set()
        t = self._thread
        if join and t is not None:
            t.join(timeout=timeout)
            if t.is_alive():
                # a tick outlived the timeout: keep ``running`` True rather
                # than race a live loop over slot state; retry stop()
                raise RuntimeError(
                    f"engine loop still ticking after {timeout}s: retry "
                    f"stop()")
        self._thread = None
        with self._lock:
            queued = bool(self.pending or self._fork_ops)
        inflight = any(r is not None for r in self.slot_req)
        if was_running and (queued or inflight):
            self._fail_inflight(
                RuntimeError("engine stopped with the request in flight"))

    def _loop(self, idle_min: float, idle_max: float) -> None:
        idle = idle_min
        while not self._stop_flag:
            try:
                progressed = self.step()
            except Exception as e:          # fail the requests, keep the
                self._fail_inflight(e)      # loop serving new work
                progressed = False
            if progressed:
                idle = idle_min
            else:
                self._wake.wait(idle)
                self._wake.clear()
                idle = min(idle * 2.0, idle_max)

    def _fail_inflight(self, exc: BaseException) -> None:
        """A tick raised: every queued, forking, parked and in-flight
        request ends with ``exc`` (waiters unblock through ``on_done``),
        every slot's blocks go back to the pool, and the slot state resets
        so that serving goes on."""
        with self._lock:
            victims = self.pending[:]
            self.pending.clear()
            for _parent, kids in self._fork_ops:
                victims += kids
            self._fork_ops.clear()
        victims += [r for r in self.slot_req if r is not None]
        for slot in range(self.slots):
            # also a slot whose request never landed (an admission that
            # raised after allocating): its blocks return to the pool
            if self.slot_req[slot] is not None or (
                    self.paged and self._slot_blocks[slot]):
                self._release_slot(slot)
        self._slot_pos[:] = 0
        self._deactivate.clear()
        self._prefills.clear()
        self._held_logits.clear()
        self._held_state.clear()
        if self.paged:
            # the next step uploads the emptied table before any admission
            self._fresh_blocks.clear()
            self._table[:] = -1
            self._table_dirty = True
        for req in victims:
            self._finalize(req, exc)
        # device state last: the waiters are already free if it raises too
        self._state = {k: torch.zeros_like(v) for k, v in self._state.items()}

    @property
    def cache_bytes(self) -> int:
        """Resident decode-cache bytes (block pool and tables, or rings)."""
        return sum(t.numel() * t.element_size()
                   for leaf in self.cache.values() for t in leaf)

    def health_stats(self) -> Dict[str, Any]:
        """Queue, slot and counter snapshot for ``/v1/healthz``: the one
        accessor that request handler threads use."""
        with self._lock:
            pending = len(self.pending)
            ticks = self.ticks
        active = sum(r is not None for r in self.slot_req)
        return {
            "running": self.running,
            "ticks": ticks,
            "pending": pending,
            "active_slots": active,
            "slots": self.slots,
            "memory": self.pool_stats(),
        }

    def pool_stats(self) -> Dict[str, object]:
        """Allocator watermarks and scheduler counters.  Every block count
        is of physical blocks: a block shared by k owners counts once, and
        sharing is reported on its own."""
        with self._lock:
            stats: Dict[str, object] = {
                "cache": "paged" if self.paged else "ring",
                "cache_bytes": self.cache_bytes,
                "peak_active": self.peak_active,
                "preemptions": self.preemptions,
                "forks": self.forks,
            }
            if self.paged:
                a = self.allocator
                stats.update(
                    block_size=self.block_size, blocks=a.num_blocks,
                    blocks_free=a.free, blocks_used=a.used,
                    blocks_peak_used=a.peak_used,
                    utilization=a.used / max(a.capacity, 1),
                    shared_blocks=self.pool.shared_blocks,
                    shared_blocks_peak=self.pool.peak_shared,
                    cow_copies=self.pool.cow_copies,
                    prefill_chunk_tokens=self.prefill_chunk_tokens,
                    chunked_prefills=self.chunked_prefills,
                    prefill_chunks=self.prefill_chunks,
                    prefill_in_progress=len(self._prefills),
                    suffix_tokens_saved=self.suffix_tokens_saved)
                stats["prefix_cache"] = (self.prefix.stats()
                                         if self.prefix is not None else None)
        return stats

    # -- request lifecycle ----------------------------------------------------
    def _finalize(self, req: Request,
                  error: Optional[BaseException] = None) -> None:
        if error is not None:
            req.error = error
        req.done = True
        with self._lock:
            self._by_id.pop(req.request_id, None)
            self._cancel_ids.discard(req.request_id)
        if req.error is None and self.retain_completed:
            self.completed.append(req)
        if req.on_done is not None:
            req.on_done(req)

    def _release_slot(self, slot: int) -> None:
        """Detach the slot's request and drop its block references (a block
        frees only when no other owner holds it)."""
        self.slot_req[slot] = None
        self._held_logits.pop(slot, None)
        self._held_state.pop(slot, None)
        # a slot evicted mid-prefill drops its progress with its blocks
        self._prefills.pop(slot, None)
        if self.paged:
            ids = self._slot_blocks[slot]
            if ids:
                self.pool.release(ids)
            self._slot_blocks[slot] = []
            self._table[slot, :] = -1
            self._table_dirty = True

    def _evict(self, slot: int, *, requeue: bool,
               error: Optional[BaseException] = None) -> None:
        """Take an in-flight request out of its slot: free its blocks, queue
        the device row's deactivation, and either requeue it at the front
        (preemption: it resumes by re-prefilling what it had) or finish it
        with ``error`` (cancel, timeout)."""
        req = self.slot_req[slot]
        self._release_slot(slot)
        self._deactivate.append(slot)
        if requeue:
            self.preemptions += 1
            with self._lock:
                self.pending.insert(0, req)
        else:
            self._finalize(req, error)

    def _apply_control(self) -> None:
        """Tick-start pass: apply cancellations and expire deadlines, for
        queued, parked, in-flight and not yet landed fork children."""
        if not self._cancel_ids and self.request_timeout is None:
            return
        now = time.monotonic()

        def why(r: Request) -> Optional[BaseException]:
            if r.request_id in ids:
                return RequestCancelledError("request cancelled")
            if r._deadline is not None and now > r._deadline:
                return RequestTimeoutError(
                    "request exceeded its engine deadline")
            return None

        drop = []
        with self._lock:
            ids = set(self._cancel_ids)
            for queue in [self.pending] + [k for _, k in self._fork_ops]:
                errs = [(r, why(r)) for r in queue]
                queue[:] = [r for r, e in errs if e is None]
                drop += [(r, e) for r, e in errs if e is not None]
        for r, err in drop:
            self._finalize(r, err)
        for slot, r in enumerate(self.slot_req):
            if r is not None:
                err = why(r)
                if err is not None:
                    self._evict(slot, requeue=False, error=err)
        with self._lock:
            self._cancel_ids -= ids

    # -- paged-pool scheduling ------------------------------------------------
    def _eff_len(self, r: Request) -> int:
        """Effective prompt length: the history plus the events emitted
        before a preemption (a resume re-prefills both)."""
        return len(r.tokens) + len(r.out_tokens or ())

    def _prompt_state(self, r: Request):
        """(tokens, ages, remaining max_new) for admission: the request as
        submitted, or its history plus its events when it resumes after a
        preemption."""
        if not r.out_tokens:
            return np.asarray(r.tokens), r.ages, r.max_new
        toks = np.concatenate([np.asarray(r.tokens, np.int64),
                               np.asarray(r.out_tokens, np.int64)])
        ages = None
        if r.ages is not None:
            ages = np.concatenate([np.asarray(r.ages, np.float64),
                                   np.asarray(r.out_ages, np.float64)])
        return toks, ages, r.max_new - len(r.out_tokens)

    def _prompt_digests(self, r: Request):
        """Memoized index digests of the effective prompt; None when the
        index is off or the prompt wraps the ring (an over-width history's
        blocks hold the wrapped window, not the prompt's chunks)."""
        if self.prefix is None or self._eff_len(r) > self.max_context:
            return None
        n = self._eff_len(r)
        if r._pfx is None or r._pfx[0] != n:
            toks, ags, _ = self._prompt_state(r)
            full, key = self.prefix.digests(toks, ags)
            r._pfx = (n, full, key)
        return r._pfx

    def _prefix_hits_for(self, r: Request) -> List[int]:
        """The resident run of full blocks the index can lend this request."""
        pfx = self._prompt_digests(r)
        return [] if pfx is None else self.prefix.match_run(pfx[1])

    def _full_entry_for(self, r: Request):
        """A complete index entry matching this request's whole effective
        prompt: admission then needs no prefill at all."""
        pfx = self._prompt_digests(r)
        return None if pfx is None else self.prefix.lookup_key(pfx[2])

    def _fresh_need(self, m: int) -> int:
        """Blocks an m-token prompt takes, plus the growth block its first
        decode write needs when it ends on a block edge (and does not wrap):
        admitting without it could preempt the request on its first tick."""
        return -(-m // self.block_size) + (
            1 if m % self.block_size == 0 and m < self.max_context else 0)

    def _chunked_for(self, r: Request) -> bool:
        """Whether this request admits through chunked prefill.  An
        over-width prompt keeps the monolithic prefill: its blocks hold the
        wrapped window, which chunks cannot build one after another."""
        return (self.prefill_chunk_tokens is not None
                and self._eff_len(r) <= self.max_context)

    def _admission_plan(self, r: Request) -> Tuple[str, int, List[int]]:
        """(kind, fresh blocks needed, index blocks this admission would pin
        by sharing).  Blocks lent by the index cost nothing from the free
        list but stop being evictable once shared.  A complete-entry
        ("ref") admission reserves one block for its first COW or growth."""
        if not self.paged:
            return "prefill", 0, []
        entry = self._full_entry_for(r)
        if entry is not None:
            return "ref", 1, list(entry.blocks)
        m = min(self._eff_len(r), self.max_context)
        hits = self._prefix_hits_for(r)
        if self._chunked_for(r) and len(hits) * self.block_size >= m:
            # a chunked admission keeps >= 1 suffix token for its bootstrap
            # logits (_admit_chunked trims the same way)
            hits = hits[:(m - 1) // self.block_size]
        return "prefill", self._fresh_need(m) - len(hits), hits

    def _ensure_blocks(self) -> None:
        """Every decoding slot must own, alone, the block its next write
        lands in: an unallocated destination gets a fresh block (its stale
        positions reset before the tick), and a destination shared with
        other owners (forked siblings, the index) is copied first.  On pool
        exhaustion the youngest request is preempted until the rest fit.
        Held parents never write real data and are skipped, and so are slots
        mid-prefill (their blocks were allocated whole at admission); both
        still hold blocks, so a mid-prefill slot can be preempted."""
        W, bs = self.max_context, self.block_size
        while True:
            needy = []
            for slot, r in enumerate(self.slot_req):
                if r is None or r.hold or slot in self._prefills:
                    continue
                jb = int(self._slot_pos[slot] % W) // bs
                bid = int(self._table[slot, jb])
                if bid < 0:
                    needy.append((slot, jb, None))
                elif self.pool.refcount(bid) > 1:
                    needy.append((slot, jb, bid))        # COW before write
            if not needy:
                return
            exhausted = False
            for slot, jb, old in needy:
                if old is not None and self.pool.refcount(old) == 1:
                    # the other sharers copied away earlier in this pass:
                    # this slot owns the block alone now
                    continue
                got = self.pool.alloc(1)
                if got is None:
                    exhausted = True
                    break
                new = got[0]
                if old is None:
                    self._slot_blocks[slot].append(new)
                    self._fresh_blocks.append(new)
                else:
                    try:       # the copy carries valid positions: no reset
                        _cow_block(self.cache, old, new)
                    except BaseException:
                        self.pool.release([new])   # the copy never landed
                        raise
                    blocks = self._slot_blocks[slot]
                    blocks[blocks.index(old)] = new
                    self.pool.release([old])
                    self.pool.cow_copies += 1
                self._table[slot, jb] = new
                self._table_dirty = True
            if not exhausted:
                return
            victims = [i for i, r in enumerate(self.slot_req)
                       if r is not None and not r.hold]
            victim = max(victims, key=lambda s: self.slot_req[s]._seq)
            self._evict(victim, requeue=True)

    def _flush_slot_updates(self) -> None:
        """Push queued host bookkeeping to the device before the tick:
        evicted and parked slots deactivate, fresh growth blocks lose their
        stale positions, and the block table uploads (host->device copies,
        on the tick's stream)."""
        if self._deactivate:
            keep = np.ones(self.slots, bool)
            keep[self._deactivate] = False
            self._state["active"] &= self._dev(keep)
            self._deactivate.clear()
        if not self.paged:
            return
        if self._fresh_blocks:
            _reset_pos(self.cache, self._fresh_blocks)
            self._fresh_blocks.clear()
        if self._table_dirty:
            tab = self._table
            if self._held_logits or self._prefills:
                # a held slot still rides the tick: its discarded write must
                # not land in its (shared) tail block, so that column is -1
                # in the device copy and the write goes to the trash block
                tab = tab.copy()
                W, bs = self.max_context, self.block_size
                for slot in self._held_logits:
                    tab[slot, int(self._slot_pos[slot] % W) // bs] = -1
                # a slot mid-prefill: its whole row, until the last chunk
                for slot in self._prefills:
                    tab[slot, :] = -1
            self.cache["self"].table.copy_(torch.from_numpy(tab))
            self._table_dirty = False

    # -- admission: bucketed batched prefill --------------------------------
    def _select_admission(self):
        """Pop the next admission off ``pending`` (lock held).  Returns
        (kind, group, slots, injected) or None:

        * ``"ref"``: the head's whole prompt hit a complete index entry;
          it admits alone by reference, with no prefill.
        * ``"prefill"``: a bucketed prefill cohort, up to the free slots
          (one for a recurrent model), all injected or all generator-
          sampled, budgeted in paged mode by available blocks (free plus
          index-evictable; blocks the cohort will share are not counted
          as evictable).  Held parents and over-width prompts admit alone.

        Admission is FIFO: a large request waits for blocks rather than
        being passed by later small ones."""
        if not self.pending:
            return None
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        if not free:
            return None
        head = self.pending[0]
        injected = head.uniforms is not None
        # one tick samples every slot from ONE uniform source; held parents
        # sample nothing and go with either
        occupied = [r for r in self.slot_req if r is not None and not r.hold]
        if occupied and (occupied[0].uniforms is not None) != injected \
                and not head.hold:
            return None
        pinned: set = set()
        fresh_taken = 0

        def fits(needed: int, pins: List[int]) -> bool:
            if not self.paged:
                return True
            if self.pool.free - fresh_taken >= needed:
                return True
            return (self.pool.available(pinned | set(pins)) - fresh_taken
                    >= needed)

        def admissible(r: Request):
            """The request's plan, or a fully fresh plan when its pins do
            not fit (eviction may then take the hit blocks), or None."""
            kind, needed, pins = self._admission_plan(r)
            if fits(needed, pins):
                return kind, needed, pins
            if self.paged and pins:
                fresh = self._fresh_need(min(self._eff_len(r),
                                             self.max_context))
                if fits(fresh, []):
                    return "prefill", fresh, []
            return None

        plan = admissible(head)
        if plan is None:
            return None
        if plan[0] == "ref":
            return "ref", [self.pending.pop(0)], free[:1], injected
        group: List[Request] = []
        limit = len(free) if self.bucketed else 1
        if head.hold or self._eff_len(head) > self.max_context:
            limit = 1
        while self.pending and len(group) < limit \
                and (self.pending[0].uniforms is not None) == injected:
            cand = self.pending[0]
            if group and (self._eff_len(cand) > self.max_context
                          or cand.hold):
                break
            plan = admissible(cand)
            if plan is None or (group and plan[0] == "ref"):
                break                      # complete hits admit alone next
            pinned |= set(plan[2])
            fresh_taken += plan[1]
            group.append(self.pending.pop(0))
        if not group:
            return None
        return "prefill", group, free[:len(group)], injected

    def _admit(self) -> None:
        while True:
            with self._lock:
                sel = self._select_admission()
            if sel is None:
                return
            kind, group, slot_ids, injected = sel
            if kind == "ref":
                self._admit_ref(group[0], slot_ids[0], injected)
            elif self._chunked_for(group[0]):
                # chunked admissions only stage their prompts: the chunks
                # run in _run_prefill_chunks.  An over-width prompt admits
                # alone, so a chunk-eligible head means an eligible group
                for j, (req, slot) in enumerate(zip(group, slot_ids)):
                    try:
                        self._admit_chunked(req, slot)
                    except Exception:
                        with self._lock:
                            self.pending[:0] = group[j + 1:]
                        raise
            else:
                self._admit_group(group, slot_ids, injected)

    def _admit_group(self, group: List[Request], slot_ids: List[int],
                     injected: bool) -> None:
        try:
            self._admit_group_inner(group, slot_ids, injected)
        except Exception:
            # a failed admission returns the blocks it took and puts its
            # un-slotted cohort back at the front of the queue
            if self.paged:
                for slot in slot_ids:
                    if self.slot_req[slot] is None and self._slot_blocks[slot]:
                        self._release_slot(slot)
            with self._lock:
                self.pending[:0] = [r for r in group
                                    if not r.done and r not in self.slot_req]
            raise

    def _admit_group_inner(self, group: List[Request], slot_ids: List[int],
                           injected: bool) -> None:
        n = len(group)
        prompts = [self._prompt_state(r) for r in group]
        lens = [len(p[0]) for p in prompts]
        if self.bucketed and max(lens) <= self.max_context:
            # never bucket past the ring width: a pad-rounded S > W would
            # evict valid prompt context through the S > W ring pack
            sb = min(_seq_bucket(max(lens)), self.max_context)
            nb = min(_next_pow2(n), self.slots)
        else:
            # exact shape: a solo over-width prompt, or recurrent state
            sb, nb = max(lens), n
        self.prefill_shapes.add((nb, sb))

        tokens = np.zeros((nb, sb), np.int32)
        ages = np.zeros((nb, sb), np.float32)
        age0 = np.zeros((nb,), np.float32)
        lengths = np.full((nb,), lens[0], np.int32)
        max_new = np.full((nb,), 1, np.int32)
        for j, (toks, ags, remaining) in enumerate(prompts):
            S = lens[j]
            tokens[j, :S] = toks
            if ags is not None:
                ages[j, :S] = ags
                ages[j, S:] = ags[-1]
                age0[j] = np.float32(ags[-1])
            lengths[j] = S
            max_new[j] = remaining
        tokens[n:] = tokens[0]       # padded admission rows: clones of row 0,
        ages[n:] = ages[0]           # computed and discarded
        hold = group[0].hold         # hold parents admit alone
        if injected or hold:
            # a hold admission samples nothing: filler uniforms, row unused
            u = np.full((nb, self.cfg.vocab_size), 0.5, np.float32)
            if not hold:
                for j, r in enumerate(group):
                    # a resumed (preempted) request has consumed its first
                    # len(out_tokens) rows already
                    u[j] = r.uniforms[len(r.out_tokens)]
            u_t = self._dev(u)
        else:
            u_t = self._rand(nb)
        cache_rows, rows, packed, lg = _prefill_core(
            self._wparams, self._dev(tokens), self._dev(ages),
            self._dev(lengths - 1), self._dev(age0), self._dev(lengths),
            self._dev(max_new), u_t, self.cfg, self._kn)

        ids = self._dev(np.asarray(slot_ids, np.int64))
        if self.paged:
            W, bs = self.max_context, self.block_size
            nblk = -(-min(sb, W) // bs)
            dst = np.zeros((n, nblk), np.int64)      # unneeded tail -> trash
            for j, (req, slot) in enumerate(zip(group, slot_ids)):
                nb_j = -(-min(lens[j], W) // bs)
                # index hits are taken by REFERENCE: their prefill rows go
                # to the trash and only the suffix gets fresh blocks.  The
                # shares come before the alloc (which may evict index
                # entries), and park on the slot at once so that a failed
                # alloc releases them with the rest of the cohort.
                hits = self._prefix_hits_for(req)[:nb_j]
                if hits:
                    self.pool.share(hits)
                    self.prefix.partial_hits += 1
                    self._slot_blocks[slot] = list(hits)
                alloc = self.pool.alloc(nb_j - len(hits))
                if alloc is None:                    # _select budgeted this
                    raise RuntimeError("admission outran the block budget")
                self._slot_blocks[slot] = hits + alloc
                self._table[slot, :] = -1
                self._table[slot, :nb_j] = self._slot_blocks[slot]
                dst[j, len(hits):nb_j] = alloc
            self._table_dirty = True
            _insert_blocks(self.cache, cache_rows, self._dev(dst), n, nblk)
            self._flush_slot_updates()
        else:
            _insert_rows(self.cache, cache_rows, ids, n)
        _commit(self._state, ids, rows, n)

        self.admit_batches += 1
        arr = self._fetch(packed)    # ONE sync per admission batch
        for j, (req, slot) in enumerate(zip(group, slot_ids)):
            self.slot_req[slot] = req
            self._slot_pos[slot] = lens[j]
            if self.prefix is not None and lens[j] <= self.max_context \
                    and not req.out_tokens:
                self._register_prefix(req, prompts[j], slot, lens[j],
                                      float(age0[j]), lg[j])
            if req.hold:
                # park: keep the bootstrap logits, deactivate the device row
                # (its discarded tick writes go to the trash block), emit
                # nothing until the fork
                self._held_logits[slot] = lg[j]
                if "ssm" in cache_rows:
                    self._held_state[slot] = {"ssm": tuple(
                        t[:, j:j + 1].clone() for t in cache_rows["ssm"])}
                self._deactivate.append(slot)
            else:
                self._apply_host(req, slot, arr[:, j])

    def _register_prefix(self, req: Request, prompt, slot: int, S: int,
                         age0: float, logits: torch.Tensor) -> None:
        """Index an admitted prompt's blocks.  A hold parent registers a
        complete entry (its partial tail block and bootstrap logits too):
        an identical later prompt admits with no prefill.  A decoding
        request registers its full blocks only: sharing the tail it writes
        into would cost a copy per admission."""
        full = S // self.block_size
        pfx = self._prompt_digests(req)          # memoized: no re-hash
        toks, ags, _ = prompt
        if req.hold:
            self.prefix.register(toks, ags, list(self._slot_blocks[slot]),
                                 S=S, age0=age0, logits=logits,
                                 digests=(pfx[1], pfx[2]))
        elif full:
            cut = full * self.block_size
            self.prefix.register(
                toks[:cut], None if ags is None else ags[:cut],
                self._slot_blocks[slot][:full], S=cut, age0=age0,
                digests=(pfx[1][:full], self.prefix.aligned_key(pfx[1], full)))
        self.prefix.misses += 1

    def _admit_ref(self, req: Request, slot: int, injected: bool) -> None:
        """Admission by reference: the whole prompt matched a complete index
        entry, so the request shares the entry's blocks and samples its
        first event from the entry's bootstrap logits; no prefill runs.  A
        hold parent parks on the shared blocks the same way."""
        entry = self._full_entry_for(req)
        if entry is None:               # evicted since selection: requeue
            with self._lock:
                self.pending.insert(0, req)
            return
        self.prefix.hits += 1
        self.prefix.touch(entry)
        self.pool.share(entry.blocks)
        self._slot_blocks[slot] = list(entry.blocks)
        self._table[slot, :] = -1
        self._table[slot, :len(entry.blocks)] = entry.blocks
        self._table_dirty = True
        self.slot_req[slot] = req
        self._slot_pos[slot] = entry.S
        if req.hold:
            self._held_logits[slot] = entry.logits
            self._deactivate.append(slot)
            return
        if injected:
            u = self._dev(req.uniforms[len(req.out_tokens)][None])
        else:
            u = self._rand(1)
        rows, packed = _fork_rows_core(
            entry.logits[None], u, self._dev(np.float32([entry.age0])),
            self._dev(np.int32([entry.S])),
            self._dev(np.int32([req.max_new - len(req.out_tokens)])),
            self._kn)
        _commit(self._state, self._dev(np.int64([slot])), rows, 1)
        self.admit_batches += 1
        arr = self._fetch(packed)       # ONE sync, like any admission batch
        self._apply_host(req, slot, arr[:, 0])

    # -- chunked prefill --------------------------------------------------------
    def _admit_chunked(self, req: Request, slot: int) -> None:
        """Stage a chunked prefill: allocate the prompt's blocks, share any
        indexed prefix run by reference, and set the cursor at the matched
        boundary.  No forward runs here: :meth:`_run_prefill_chunks` meters
        the suffix through ``prefill_chunk_tokens`` between ticks."""
        toks, ags, remaining = self._prompt_state(req)
        S = len(toks)
        bs = self.block_size
        nb = -(-S // bs)
        hits = self._prefix_hits_for(req)[:nb]
        if len(hits) * bs >= S:
            # keep >= 1 suffix token: the final chunk's logits bootstrap the
            # first event (a complete-entry hit admits by reference instead)
            hits = hits[:(S - 1) // bs]
        try:
            if hits:
                self.pool.share(hits)
                self.prefix.partial_hits += 1
                # parked on the slot at once, so that a failed alloc below
                # releases them with the rest
                self._slot_blocks[slot] = list(hits)
            alloc = self.pool.alloc(nb - len(hits))
            if alloc is None:                    # _select budgeted this
                raise RuntimeError("admission outran the block budget")
        except Exception:
            if self._slot_blocks[slot]:
                self._release_slot(slot)
            with self._lock:
                if not req.done:
                    self.pending.insert(0, req)
            raise
        self._slot_blocks[slot] = hits + alloc
        self._table[slot, :] = -1
        self._table[slot, :nb] = self._slot_blocks[slot]
        self._table_dirty = True
        self.slot_req[slot] = req
        self._slot_pos[slot] = 0
        cursor = len(hits) * bs
        self.suffix_tokens_saved += cursor
        self.chunked_prefills += 1
        self._prefills[slot] = _PrefillProgress(
            req=req, tokens=np.asarray(toks), ages=ags, max_new=remaining,
            age0=float(ags[-1]) if ags is not None else 0.0, S=S,
            cursor=cursor)

    def _run_prefill_chunks(self) -> bool:
        """Spend this step's chunk budget over the prefills in progress,
        oldest request first.  A prefill whose last chunk lands bootstraps
        its first event at once (or parks, for a hold parent) and ticks in
        this very step."""
        budget = self.prefill_chunk_tokens
        bs = self.block_size
        progressed = False
        for slot in sorted(self._prefills,
                           key=lambda s: self._prefills[s].req._seq):
            st = self._prefills[slot]
            if budget < min(bs, st.S - st.cursor):
                break                   # budget spent: FIFO, no backfill
            n = _chunk_len(st.S, st.cursor, budget, bs)
            self._run_one_chunk(slot, st, n)
            budget -= n
            progressed = True
        return progressed

    def _run_one_chunk(self, slot: int, st: _PrefillProgress, n: int) -> None:
        arrays = _chunk_arrays(st.tokens, st.ages, st.cursor, n,
                               self.block_size, self._table[slot])
        tokens, _, _, ctx_ids = arrays[:4]
        width = _chunk_width(n, tokens.shape[1], self.max_context)
        self.prefill_shapes.add(("chunk", ctx_ids.shape[1], width))
        lg = _suffix_chunk_core(self._wparams, self.cache,
                                *(self._dev(a) for a in arrays), self.cfg,
                                width)
        st.cursor += n
        self.prefill_chunks += 1
        if st.cursor >= st.S:
            self._finish_prefill(slot, st, lg[0])

    def _finish_prefill(self, slot: int, st: _PrefillProgress,
                        logits: torch.Tensor) -> None:
        """The last chunk landed: unmask the slot's table row, index the
        prompt, then park (a hold parent) or sample the first event from
        the final chunk's logits, the tail of a monolithic admission."""
        req = st.req
        del self._prefills[slot]
        self._slot_pos[slot] = st.S
        self._table_dirty = True        # unmask: the row is written
        if self.prefix is not None and not req.out_tokens:
            self._register_prefix(req, (st.tokens, st.ages, st.max_new),
                                  slot, st.S, st.age0, logits)
        if req.hold:
            # park on the written blocks; the device row was never active
            self._held_logits[slot] = logits
            return
        if req.uniforms is not None:
            u = self._dev(req.uniforms[len(req.out_tokens)][None])
        else:
            u = self._rand(1)
        rows, packed = _fork_rows_core(
            logits[None], u, self._dev(np.float32([st.age0])),
            self._dev(np.int32([st.S])), self._dev(np.int32([st.max_new])),
            self._kn)
        _commit(self._state, self._dev(np.int64([slot])), rows, 1)
        self.admit_batches += 1
        arr = self._fetch(packed)       # ONE sync, like any admission batch
        self._apply_host(req, slot, arr[:, 0])

    # -- fork application -----------------------------------------------------
    def _apply_forks(self) -> bool:
        """Apply the queued fork ops whose parent is parked in a slot.  A
        parent that finished (cancelled, expired) fails its children; one
        still pending or mid-chunked-prefill, or whose uniform source
        differs from the decoding cohort's, waits."""
        with self._lock:
            ops = self._fork_ops[:]
            self._fork_ops.clear()
        if not ops:
            return False
        deferred: List[Tuple[Request, List[Request]]] = []
        progressed = False
        for parent, kids in ops:
            if parent.done:
                err = (parent.error if parent.error is not None else
                       InvalidRequestError(
                           f"fork parent {parent.request_id!r} is gone "
                           f"(cancelled, expired or failed before the fork "
                           f"applied)"))
                for c in kids:
                    self._finalize(c, err)
                progressed = True
                continue
            if parent not in self.slot_req:
                deferred.append((parent, kids))     # parent still pending
                continue
            pslot = self.slot_req.index(parent)
            if pslot in self._prefills:
                # no bootstrap logits yet: the fork applies once the
                # parent's last chunk lands
                deferred.append((parent, kids))
                continue
            injected = bool(kids) and kids[0].uniforms is not None
            occupied = [r for r in self.slot_req
                        if r is not None and not r.hold]
            if kids and occupied \
                    and (occupied[0].uniforms is not None) != injected:
                deferred.append((parent, kids))     # uniform-source mismatch
                continue
            # the temporary reference keeps the parent's blocks alive across
            # its release, and is dropped on every way out
            blocks: List[int] = []
            tab = None
            if self.paged:
                blocks = list(self._slot_blocks[pslot])
                tab = self._table[pslot].copy()
                self.pool.share(blocks)
            try:
                self._apply_one_fork(parent, kids, pslot, blocks, tab,
                                     injected)
            finally:
                if self.paged:
                    self.pool.release(blocks)
            progressed = True
        if deferred:
            with self._lock:
                self._fork_ops[:0] = deferred
        return progressed

    def _apply_one_fork(self, parent: Request, kids: List[Request],
                        pslot: int, blocks: List[int], tab,
                        injected: bool) -> None:
        """Consume one held parent: release its slot, land as many children
        as there are free slots (shared blocks or a copied ring row, then
        one bootstrap), and queue the rest."""
        logits = self._held_logits[pslot]
        state = self._held_state.get(pslot)
        S = int(self._slot_pos[pslot])
        age0 = float(parent.ages[-1]) if parent.ages is not None else 0.0
        self._release_slot(pslot)
        self._finalize(parent)
        self.forks += 1
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        k = min(len(kids), len(free))
        wave, rest = kids[:k], kids[k:]
        if rest:
            with self._lock:
                self.pending[:0] = rest
        if not wave:
            return
        wave_slots = free[:k]
        # a hold admitted in this step may have queued its slot for
        # deactivation: a child landing there must stay active
        self._deactivate = [s for s in self._deactivate
                            if s not in wave_slots]
        if self.paged:
            for s in wave_slots:
                self.pool.share(blocks)
                self._slot_blocks[s] = list(blocks)
                self._table[s] = tab
            self._table_dirty = True
        else:
            if state is not None:       # the parent's state as admitted
                _insert_rows(self.cache, state, self._dev(np.int64([pslot])),
                             1)
            _fork_copy_rows(self.cache, pslot, wave_slots, S - 1)
        kb = _next_pow2(k)
        V = self.cfg.vocab_size
        mn = np.full((kb,), 1, np.int32)
        for j, c in enumerate(wave):
            mn[j] = c.max_new
        if injected:
            u = np.full((kb, V), 0.5, np.float32)
            for j, c in enumerate(wave):
                u[j] = c.uniforms[0]
            u_t = self._dev(u)
        else:
            u_t = self._rand(kb)
        rows, packed = _fork_rows_core(
            logits[None].expand(kb, V), u_t,
            self._dev(np.full((kb,), age0, np.float32)),
            self._dev(np.full((kb,), S, np.int32)), self._dev(mn), self._kn)
        _commit(self._state, self._dev(np.asarray(wave_slots, np.int64)),
                rows, k)
        self.admit_batches += 1
        arr = self._fetch(packed)       # ONE sync per fork wave
        for j, (c, s) in enumerate(zip(wave, wave_slots)):
            self.slot_req[s] = c
            self._slot_pos[s] = S
            self._apply_host(c, s, arr[:, j])

    # -- the tick ------------------------------------------------------------
    def _rand(self, rows: int) -> torch.Tensor:
        return torch.rand((rows, self.cfg.vocab_size), generator=self._gen,
                          device=self.device)

    def _apply_host(self, req: Request, slot: int, col: np.ndarray) -> None:
        evt, age, emit, finished = col
        if emit >= 0.5:
            req.out_tokens.append(int(evt))
            if self.is_delphi:
                req.out_ages.append(float(age))
            if req.on_event is not None:
                req.on_event(int(evt), float(age) if self.is_delphi else None)
        if finished >= 0.5:
            self._release_slot(slot)     # returns paged blocks to the pool
            self._finalize(req)

    def step(self) -> bool:
        """One engine tick: control pass (cancel/timeout), admission, fork
        ops, the chunk budget, paged block growth/COW/preemption, then
        decode + sample every decoding slot on the device."""
        self._apply_control()
        self._flush_slot_updates()   # deactivations BEFORE slots are reused
        self._admit()
        forked = self._apply_forks()
        chunked = bool(self._prefills) and self._run_prefill_chunks()
        if self.paged:
            self._ensure_blocks()
        self._flush_slot_updates()
        active = [i for i, r in enumerate(self.slot_req)
                  if r is not None and not r.hold and i not in self._prefills]
        if not active:
            return forked or chunked
        self.ticks += 1
        self.peak_active = max(self.peak_active, len(active))
        injected = [i for i in active if self.slot_req[i].uniforms is not None]
        if injected and len(injected) != len(active):
            raise ValueError("cannot mix uniform-injected and generator-"
                             "sampled requests in one tick")
        if injected:
            u = np.full((self.slots, self.cfg.vocab_size), 0.5, np.float32)
            for i in active:
                r = self.slot_req[i]
                u[i] = r.uniforms[len(r.out_tokens)]
            u_t = self._dev(u)
        else:
            u_t = self._rand(self.slots)
        self._state, packed = _tick_core(self._wparams, self.cache,
                                         self._state, u_t, self.cfg, self._kn)
        self._slot_pos[active] += 1     # mirror the device's step advance
        arr = self._fetch(packed)       # ONE sync per tick
        for slot in active:
            self._apply_host(self.slot_req[slot], slot, arr[:, slot])
        return True

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        """Tick until every submitted request has finished."""
        ticks = 0
        while (self.pending or self._fork_ops
               or any(r is not None for r in self.slot_req)) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.completed
