"""Copy-on-write prefix sharing for the paged KV cache (the JAX package's
``serve/prefix.py``, host-side and numpy + hashlib only, copied).

Risk is read off many sampled futures of one patient history, so N requests
with a common history can share the KV blocks of that history:

* :class:`SharedBlockPool`: per-block refcounts over the engine's
  ``BlockAllocator``.  ``alloc`` hands out blocks at refcount 1, ``share``
  adds references, ``release`` drops one and frees a block at 0.  The
  engine copies a block (copy-on-write) before a slot writes into one it
  does not own alone, so a shared prefix never changes while referenced.
* :class:`PrefixIndex`: an LRU index over the full blocks of admitted
  prompts, keyed by chained digests of their (token, age) chunks.
  Admission shares the longest resident run of blocks by reference; a
  complete entry (full blocks, partial tail block and bootstrap logits,
  registered by ``hold`` admissions) admits an identical prompt with no
  prefill at all.
* :func:`ring_reference_futures`: the scheduler-free oracle of the
  engine's ``fork``: one solo prefill on a ring, the fork bootstrap and
  the decode tick, run through the engine's own module-level functions, so
  that the engine's fork (ring, paged, prefix-cached) must reproduce it bit
  for bit under injected uniforms.
* :func:`chunked_reference_trajectory`: the scheduler-free oracle of the
  paged engine, chunked or not: one request's prompt suffix through the
  engine's own chunk step, bootstrap and tick, in a straight line.

Zero leaks: after the engine drains and the index is dropped
(``BatchedEngine.drop_prefix_cache``), ``allocator.used == 0`` and no
refcount is left.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["SharedBlockPool", "PrefixIndex", "chunked_reference_trajectory",
           "prompt_digests", "ring_reference_futures"]


class SharedBlockPool:
    """Ref-counted block ownership over a ``BlockAllocator``.

    Every block handed out by :meth:`alloc` starts at refcount 1; additional
    owners (forked requests, the prefix index) attach with :meth:`share`.
    :meth:`release` drops ONE reference — the underlying allocator sees the
    free only when the last reference goes, so ``allocator.used`` keeps
    counting each physical block exactly once no matter how many requests
    reference it (the admission-budget and ``pool_stats`` contract).
    """

    def __init__(self, allocator):
        self.allocator = allocator
        self._refs: Dict[int, int] = {}
        #: block copies triggered by a write into a shared block
        self.cow_copies = 0
        #: high-water mark of concurrently shared (refcount >= 2) blocks
        self.peak_shared = 0
        #: set by the engine when the prefix index is enabled — alloc()
        #: evicts LRU index entries before giving up on pool pressure
        self.index: Optional["PrefixIndex"] = None

    # -- allocator passthrough (once-counted accounting) ---------------------
    @property
    def capacity(self) -> int:
        return self.allocator.capacity

    @property
    def free(self) -> int:
        return self.allocator.free

    @property
    def used(self) -> int:
        return self.allocator.used

    @property
    def num_blocks(self) -> int:
        return self.allocator.num_blocks

    @property
    def peak_used(self) -> int:
        return self.allocator.peak_used

    def available(self, exclude=None) -> int:
        """Admission budget: free blocks plus blocks an index eviction could
        free right now.  A block shared by a live request counts ZERO times
        (it is neither free nor evictable), and ``exclude`` removes blocks
        the caller is about to PIN by sharing them — they must not be
        double-counted as both lent-by-reference and evictable."""
        n = self.allocator.free
        if self.index is not None:
            n += self.index.evictable(exclude)
        return n

    # -- ownership ------------------------------------------------------------
    def alloc(self, n: int, *, evict: bool = True) -> Optional[List[int]]:
        """n exclusively-owned blocks (refcount 1), or None — after trying
        to make room by LRU-evicting prefix-index entries."""
        if evict and self.index is not None and n > self.allocator.free:
            self.index.evict(n - self.allocator.free)
        ids = self.allocator.alloc(n)
        if ids is not None:
            for i in ids:
                self._refs[i] = 1
        return ids

    def share(self, ids: List[int]) -> None:
        """Attach one more reference to each block (fork / prefix admit /
        index registration)."""
        for i in ids:
            r = self._refs.get(i)
            if r is None:
                raise ValueError(f"share of unallocated block {i}")
            self._refs[i] = r + 1
        self.peak_shared = max(self.peak_shared, self.shared_blocks)

    def release(self, ids: List[int]) -> None:
        """Drop one reference per block; frees into the allocator at 0."""
        for i in ids:
            r = self._refs.get(i)
            if r is None:
                raise ValueError(f"release of unowned block {i}")
            if r == 1:
                del self._refs[i]
                self.allocator.release([i])
            else:
                self._refs[i] = r - 1

    def refcount(self, block_id: int) -> int:
        return self._refs.get(block_id, 0)

    @property
    def shared_blocks(self) -> int:
        """Physical blocks currently referenced by more than one owner."""
      
        # cross-thread caller is engine.pool_stats, holding the engine lock
        return sum(1 for r in self._refs.values() if r > 1)

    @property
    def total_refs(self) -> int:
      
        # cross-thread caller is engine.pool_stats, holding the engine lock
        return sum(self._refs.values())


# ---------------------------------------------------------------------------
# Prefix index
# ---------------------------------------------------------------------------
def _chunk_digest(prev: bytes, toks: np.ndarray,
                  ages: Optional[np.ndarray]) -> bytes:
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(np.ascontiguousarray(toks, np.int64).tobytes())
    if ages is not None:
        h.update(np.ascontiguousarray(ages, np.float32).tobytes())
    return h.digest()


def prompt_digests(tokens, ages, block_size: int
                   ) -> Tuple[List[bytes], bytes]:
    """Chained blake2b digests of a prompt's (token, age) history.

    Returns ``(chain, key)``: one digest per FULL ``block_size`` chunk
    (chunk ``i`` folds in chunk ``i-1``'s digest, so digest ``i`` names the
    whole prefix through block ``i``) plus a whole-prompt key that also
    folds in the partial tail and the exact length.

    The chain is the same as the JAX package's, byte for byte, so a
    prefix-affinity router can hash a history once for either package.
    """
    toks = np.asarray(tokens, np.int64)
    ags = None if ages is None else np.asarray(ages, np.float32)
    bs = block_size
    S = len(toks)
    full, prev = [], b"prefix-v1"
    for i in range(S // bs):
        prev = _chunk_digest(prev, toks[i * bs:(i + 1) * bs],
                             None if ags is None
                             else ags[i * bs:(i + 1) * bs])
        full.append(prev)
    key = prev
    if S % bs:
        key = _chunk_digest(prev, toks[-(S % bs):],
                            None if ags is None else ags[-(S % bs):])
    # fold the exact length in so "aligned prompt" vs "same prompt plus
    # an empty tail" cannot collide
    key = hashlib.blake2b(key + S.to_bytes(8, "little"),
                          digest_size=16).digest()
    return full, key


class _Entry:
    __slots__ = ("key", "chain", "blocks", "complete", "S", "age0", "logits",
                 "hits")

    def __init__(self, key, chain, blocks, complete, S, age0, logits):
        self.key = key
        self.chain = chain          # per-full-block chain digests
        self.blocks = blocks        # table-order block ids (full [+ tail])
        self.complete = complete    # tail + bootstrap logits present
        self.S = S
        self.age0 = age0
        self.logits = logits        # (V,) fp32 tensor (complete entries)
        self.hits = 0


class PrefixIndex:
    """Hash-keyed LRU index over admitted prompts' KV blocks.

    Two lookup grains:

    * :meth:`match_prefix` — longest run of FULL blocks whose (token, age)
      chunk-chain digests are resident: admission shares these by reference
      and prefills only the unmatched suffix (memory saved, compute kept) —
      also how a preempted forked request *re-acquires* its shared prefix on
      recompute resume.
    * :meth:`lookup` — exact whole-prompt match against a **complete** entry
      (registered by ``hold`` admissions: full blocks, partial tail block,
      and the prompt's bootstrap logits): admission by pure reference, no
      prefill at all — the Monte-Carlo N-futures fast path.

    The index owns one reference per block of each entry; eviction releases
    them, and a block frees only when no live request still shares it.
    """

    def __init__(self, pool: SharedBlockPool, block_size: int,
                 max_entries: int = 256):
        self.pool = pool
        self.block_size = block_size
        self.max_entries = max_entries
        self._entries: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self._chain: Dict[bytes, Tuple[int, bytes]] = {}
        pool.index = self
        self.hits = 0           # complete-entry (no-prefill) admissions
        self.partial_hits = 0   # admissions that shared >= 1 full block
        self.misses = 0
        self.evictions = 0

    # -- hashing --------------------------------------------------------------
    def _digests(self, tokens, ages) -> Tuple[List[bytes], bytes]:
        return prompt_digests(tokens, ages, self.block_size)

    # -- queries (side-effect-free: admission probes them repeatedly; the
    #    engine calls touch() only when an admission actually lands) ---------
    def digests(self, tokens, ages) -> Tuple[List[bytes], bytes]:
        """(per-full-block chain digests, whole-prompt key) — computed once
        per request and memoized by the engine (hashing a long Delphi
        history is O(S) and admission probes run under the engine lock)."""
        return self._digests(tokens, ages)

    def match_run(self, full_digests: List[bytes]) -> List[int]:
        """Longest resident run of full-block ids for a digest chain."""
        out: List[int] = []
        for d in full_digests:
            hit = self._chain.get(d)
            if hit is None:
                break
            out.append(hit[0])
        return out

    def match_prefix(self, tokens, ages) -> List[int]:
        """Longest resident run of full-block ids for this history."""
        return self.match_run(self._digests(tokens, ages)[0])

    def lookup_key(self, key: bytes) -> Optional[_Entry]:
        """Complete entry exactly matching a whole-prompt key."""
        e = self._entries.get(key)
        return e if e is not None and e.complete else None

    def lookup(self, tokens, ages) -> Optional[_Entry]:
        """Exact whole-prompt match against a complete entry."""
        return self.lookup_key(self._digests(tokens, ages)[1])

    def touch(self, entry: _Entry) -> None:
        """An admission actually used this entry: bump MRU + hit count."""
        self._entries.move_to_end(entry.key)
        entry.hits += 1

    # -- registration / eviction ----------------------------------------------
    def aligned_key(self, chain: List[bytes], n_blocks: int) -> bytes:
        """Whole-prompt key of the block-aligned truncation covering the
        first ``n_blocks`` full blocks — derived from an existing chain in
        O(1) instead of re-hashing the history."""
        prev = chain[n_blocks - 1] if n_blocks else b"prefix-v1"
        S = n_blocks * self.block_size
        return hashlib.blake2b(prev + S.to_bytes(8, "little"),
                               digest_size=16).digest()

    def register(self, tokens, ages, blocks: List[int], *, S: int,
                 age0: float, logits=None,
                 digests: Optional[Tuple[List[bytes], bytes]] = None
                 ) -> None:
        """Index an admitted prompt's blocks (the index takes one reference
        per block).  ``logits`` marks the entry complete: ``blocks`` then
        also carries the partial tail block and :meth:`lookup` can admit the
        exact prompt with no prefill.  ``digests`` passes the prompt's
        already-computed (chain, key) — the engine memoizes them per
        request, and re-hashing a long history here would serialize the
        engine thread for nothing."""
        chain, key = (digests if digests is not None
                      else self._digests(tokens, ages))
        if key in self._entries:
            self._entries.move_to_end(key)
            return
        # build the entry BEFORE taking the shares: _Entry / np.float32 can
        # raise, and shares taken first would have no owner to release them
        e = _Entry(key, chain[:len(blocks)], list(blocks),
                   logits is not None, S, np.float32(age0), logits)
        self.pool.share(blocks)
        self._entries[key] = e
        for d, b in zip(e.chain, e.blocks):
            self._chain.setdefault(d, (b, key))
        while len(self._entries) > self.max_entries:
            # trim the cap preferring entries whose eviction frees blocks;
            # pinned entries (live owners) go only when nothing else is
            # left — evicting them strands a preempted fork's re-acquire
            victim = self._freeing_victim() or next(iter(self._entries))
            self._evict_entry(victim)

    def _evict_entry(self, key: bytes) -> int:
        e = self._entries.pop(key)
        for d in e.chain:
            owner = self._chain.get(d)
            if owner is not None and owner[1] == key:
                del self._chain[d]
        before = self.pool.free
        self.pool.release(e.blocks)
        self.evictions += 1
        return self.pool.free - before

    def _evict_one(self) -> int:
        return self._evict_entry(next(iter(self._entries)))    # LRU head

    def _index_block_refs(self) -> Dict[int, int]:
        """block id -> how many index entries hold a reference to it."""
        counts: Dict[int, int] = {}
        for e in self._entries.values():
            for b in e.blocks:
                counts[b] = counts.get(b, 0) + 1
        return counts

    def _freeing_victim(self) -> Optional[bytes]:
        """LRU-most entry whose eviction makes progress toward freeing
        memory: some of its blocks are held ONLY by index entries (a block
        shared between two cached entries frees once both go — picking
        such entries repeatedly reaches the fixpoint).  Entries whose
        every block is still referenced by a live request are *pinned* —
        evicting them frees nothing and would only strand an in-flight
        fork's resume from re-acquiring its prefix."""
        counts = self._index_block_refs()
        for key, e in self._entries.items():                   # LRU order
            if any(self.pool.refcount(b) == counts.get(b, 0)
                   for b in e.blocks):
                return key
        return None

    def evict(self, need_blocks: Optional[int] = None) -> int:
        """Make room: LRU-evict entries until ``need_blocks`` blocks have
        actually freed, skipping pinned entries (see
        :meth:`_freeing_victim`).  Loops to a fixpoint, so blocks shared
        only between cached entries free once their last holder goes.
        ``need_blocks=None`` clears unconditionally (``drop_prefix_cache``
        / the zero-leak drain)."""
        freed = 0
        if need_blocks is None:
            while self._entries:
                freed += self._evict_one()
            return freed
        while freed < need_blocks:
            victim = self._freeing_victim()
            if victim is None:
                break
            freed += self._evict_entry(victim)
        return freed

    def clear(self) -> int:
        return self.evict(None)

    def evictable(self, exclude=None) -> int:
        """Blocks a pressure eviction could free right now: cached blocks
        whose every reference is an index entry (the fixpoint
        :meth:`evict` reaches).  ``exclude`` drops blocks the caller is
        about to pin by sharing them."""
        counts = self._index_block_refs()
        return sum(1 for b, c in counts.items()
                   if self.pool.refcount(b) == c
                   and (exclude is None or b not in exclude))

    # -- stats ---------------------------------------------------------------
    @property
    def entries(self) -> int:
      
        # cross-thread caller is engine.pool_stats, holding the engine lock
        return len(self._entries)

    @property
    def cached_blocks(self) -> int:
      
        # cross-thread caller is engine.pool_stats, holding the engine lock
        return len({b for e in self._entries.values() for b in e.blocks})

    def stats(self) -> Dict[str, float]:
        n = self.hits + self.misses
        return {
            "entries": self.entries,
            "cached_blocks": self.cached_blocks,
            "hits": self.hits,
            "partial_hits": self.partial_hits,
            "misses": self.misses,
            "hit_rate": self.hits / n if n else 0.0,
            "evictions": self.evictions,
        }


# ---------------------------------------------------------------------------
# Bit-parity oracle for engine fork
# ---------------------------------------------------------------------------
def ring_reference_futures(params, cfg, tokens, ages=None, *, n: int,
                           max_new: int = 48, uniforms=None,
                           slots: Optional[int] = None,
                           max_context: int = 512, temperature: float = 1.0,
                           device="cuda"
                           ) -> List[Tuple[List[int], List[float]]]:
    """Scheduler-free N-futures generation on a ring: the oracle that the
    engine's hold + fork (ring, paged, COW, prefix-cached) must match bit
    for bit.

    It bypasses everything under test (allocator, refcounts, the index,
    fork ops, preemption) and runs the engine's own module-level functions
    in a straight line: one solo bucketed prefill of the history with
    filler uniforms (``_prefill_core``, as a ``hold`` admission), the ring
    fork copy with positions past the prompt masked
    (``_fork_copy_rows``), each future's first event from the shared
    prefill logits (``_fork_rows_core``), then the decode tick
    (``_tick_core``) until every future ends.

    Bit-parity contract: ``uniforms`` (n, max_new, V) injected, the engine
    built with the same ``slots``/``max_context``/``temperature`` on the
    same device, and all n forks landing in one wave (``slots >= n``, no
    preemption: a resume re-prefills at other shapes).  ``params`` are the
    fp32 flat parameters, on ``device``.  Returns ``[(tokens, fp32 ages),
    ...]`` per future.
    """
    import torch

    from repro_torch import resolve_device
    from repro_torch.models import cast_params, make_decode_cache
    from repro_torch.serve.engine import (_commit, _fork_copy_rows,
                                          _fork_rows_core, _insert_rows,
                                          _Knobs, _next_pow2, _prefill_core,
                                          _seq_bucket, _tick_core)
    if uniforms is None:
        raise ValueError("ring_reference_futures is the injected-uniforms "
                         "parity oracle: pass uniforms (n, max_new, V)")
    uniforms = np.asarray(uniforms, np.float32)
    V = cfg.vocab_size
    if uniforms.shape != (n, max_new, V):
        raise ValueError(f"uniforms must be (n={n}, max_new={max_new}, "
                         f"V={V}); got {uniforms.shape}")
    K = n if slots is None else slots
    if K < n:
        raise ValueError(f"slots={K} cannot hold n={n} futures in one wave")
    W = max_context
    dev = resolve_device(device)
    kn = _Knobs.of(cfg, K, W, temperature)
    wparams = cast_params({k: v.to(dev) for k, v in params.items()}, cfg)

    toks = np.asarray(tokens, np.int64)
    S = len(toks)
    sb = S if S > W else min(_seq_bucket(S), W)   # over-width: exact shape
    t = np.zeros((1, sb), np.int32)
    t[0, :S] = toks
    a = np.zeros((1, sb), np.float32)
    age0 = 0.0
    if ages is not None:
        ags = np.asarray(ages, np.float32)
        a[0, :S] = ags
        a[0, S:] = ags[-1]
        age0 = float(ags[-1])

    def dv(x):
        return torch.from_numpy(np.asarray(x)).to(dev)
    cache = make_decode_cache(wparams, cfg, K, W)
    state = {
        "last": torch.zeros((K,), dtype=torch.int32, device=dev),
        "age": torch.zeros((K,), dtype=torch.float32, device=dev),
        "step": torch.zeros((K,), dtype=torch.int32, device=dev),
        "n_emitted": torch.zeros((K,), dtype=torch.int32, device=dev),
        "max_new": torch.ones((K,), dtype=torch.int32, device=dev),
        "active": torch.zeros((K,), dtype=torch.bool, device=dev),
    }
    # solo hold-style prefill: filler uniforms, the sampled row unused
    cache_rows, _rows, _packed, lg = _prefill_core(
        wparams, dv(t), dv(a), dv(np.int32([S - 1])),
        dv(np.float32([age0])), dv(np.int32([S])),
        dv(np.int32([max_new])), dv(np.full((1, V), 0.5, np.float32)),
        cfg, kn)
    _insert_rows(cache, cache_rows, dv(np.int64([0])), 1)
    # fork the prefilled row into slots 0..n-1, positions >= S masked
    _fork_copy_rows(cache, 0, list(range(n)), S - 1)
    kb = _next_pow2(n)
    u0 = np.full((kb, V), 0.5, np.float32)
    u0[:n] = uniforms[:, 0]
    rows, packed = _fork_rows_core(
        lg[0][None].expand(kb, V), dv(u0),
        dv(np.full((kb,), age0, np.float32)),
        dv(np.full((kb,), S, np.int32)),
        dv(np.full((kb,), max_new, np.int32)), kn)
    _commit(state, dv(np.arange(n, dtype=np.int64)), rows, n)

    out_t: List[List[int]] = [[] for _ in range(n)]
    out_a: List[List[float]] = [[] for _ in range(n)]
    live = [True] * n

    def apply(j, col):
        evt, age, emit, finished = col
        if emit >= 0.5:
            out_t[j].append(int(evt))
            if cfg.age_encoding:
                out_a[j].append(float(age))
        if finished >= 0.5:
            live[j] = False

    arr = packed.cpu().numpy()
    for j in range(n):
        apply(j, arr[:, j])
    while any(live):
        u = np.full((K, V), 0.5, np.float32)
        for j in range(n):
            if live[j]:
                u[j] = uniforms[j, len(out_t[j])]
        state, packed = _tick_core(wparams, cache, state, dv(u), cfg, kn)
        arr = packed.cpu().numpy()
        for j in range(n):
            if live[j]:
                apply(j, arr[:, j])
    return [(out_t[j], out_a[j]) for j in range(n)]


# ---------------------------------------------------------------------------
# Bit-parity oracle for chunked / suffix prefill
# ---------------------------------------------------------------------------
def chunked_reference_trajectory(params, cfg, tokens, ages=None, *,
                                 max_new: int, uniforms, chunk_tokens: int,
                                 slots: int = 4, max_context: int = 512,
                                 block_size: int = 16,
                                 matched_tokens: int = 0,
                                 blocks: Optional[int] = None,
                                 temperature: float = 1.0, device="cuda"
                                 ) -> Tuple[List[int], List[float]]:
    """Scheduler-free trajectory of one request on a paged pool through
    chunked suffix prefill: the oracle that the paged engine must match
    bit for bit, chunked (``prefill_chunk_tokens=chunk_tokens``) or, with
    ``chunk_tokens >= len(tokens)``, not chunked at all.

    It bypasses what is under test (admission budgeting, the per-step
    budget walk, preemption, the prefix index) and runs the engine's own
    module-level functions in a straight line: one ``_suffix_chunk_core``
    per ``_chunk_len``-sized chunk (shapes from the shared
    ``_chunk_arrays`` and ``_chunk_width``), a ``_fork_rows_core`` bootstrap from the final
    chunk's logits, then ``_tick_core`` decode ticks with block growth,
    position resets and table uploads in the engine's order.

    ``matched_tokens`` models a partial prefix-index hit: a warm pass
    chunk-prefills ``tokens[:matched_tokens]`` (block-aligned, < S) into
    blocks of its own, standing in for the indexed registrant's blocks that
    the engine's request shares by reference, and the request's cursor
    starts at that boundary.  The engine's registrant must have prefilled
    that prefix with the same ``chunk_tokens`` for the lent bytes to agree.

    Bit-parity contract: injected ``uniforms`` (max_new, V), row 0 the
    bootstrap event; the engine serves the request alone on a fresh engine
    with the same ``slots``/``max_context``/``block_size``/``temperature``
    on the same device; and ``S + max_new <= max_context`` (no ring wrap:
    the oracle never copies on write).  ``params`` are the fp32 flat
    parameters.  Returns ``(tokens, fp32 ages)``.
    """
    import torch

    from repro_torch import resolve_device
    from repro_torch.models import cast_params, make_paged_decode_cache
    from repro_torch.serve.engine import (_chunk_arrays, _chunk_len,
                                          _chunk_width, _commit,
                                          _fork_rows_core, _Knobs, _reset_pos,
                                          _suffix_chunk_core, _tick_core)
    uniforms = np.asarray(uniforms, np.float32)
    toks = np.asarray(tokens, np.int64)
    ags = None if ages is None else np.asarray(ages)
    S = len(toks)
    bs = block_size
    W = max_context
    V = cfg.vocab_size
    if uniforms.shape != (max_new, V):
        raise ValueError(f"uniforms must be (max_new={max_new}, V={V}); "
                         f"got {uniforms.shape}")
    if S + max_new > W:
        raise ValueError(
            f"S + max_new = {S + max_new} > max_context={W}: the oracle "
            f"forbids ring wrap (a wrapped slot copies on write, which this "
            f"straight line does not model)")
    if matched_tokens % bs or not 0 <= matched_tokens < S:
        raise ValueError(f"matched_tokens={matched_tokens} must be a "
                         f"block-aligned length in [0, S)")
    if chunk_tokens < bs:
        raise ValueError(f"chunk_tokens={chunk_tokens} must be >= "
                         f"block_size={bs}")
    dev = resolve_device(device)
    kn = _Knobs.of(cfg, slots, W, temperature)
    wparams = cast_params({k: v.to(dev) for k, v in params.items()}, cfg)
    nb = -(-S // bs)
    nb_warm = matched_tokens // bs
    if blocks is None:
        blocks = nb_warm + -(-(S + max_new) // bs) + 2
    cache = make_paged_decode_cache(wparams, cfg, slots, W,
                                    num_blocks=blocks, block_size=bs)
    nbs = W // bs
    next_id = 1

    def dv(x):
        return torch.from_numpy(np.asarray(x)).to(dev)

    def take(k: int) -> List[int]:
        nonlocal next_id
        ids = list(range(next_id, next_id + k))
        next_id += k
        if next_id > blocks:
            raise ValueError(f"oracle pool of {blocks} blocks exhausted")
        return ids

    def run_chunks(row, start: int, end: int):
        lg = None
        cur = start
        while cur < end:
            n = _chunk_len(end, cur, chunk_tokens, bs)
            arrays = _chunk_arrays(toks, ags, cur, n, bs, row)
            lg = _suffix_chunk_core(wparams, cache,
                                    *(dv(a) for a in arrays), cfg,
                                    _chunk_width(n, arrays[0].shape[1], W))
            cur += n
        return lg

    # warm pass: the indexed registrant's aligned prefix, in its own blocks
    warm = take(nb_warm)
    if nb_warm:
        wrow = np.full((nbs,), -1, np.int32)
        wrow[:nb_warm] = warm
        run_chunks(wrow, 0, matched_tokens)

    # the request: lent blocks + fresh suffix blocks, cursor at the match
    row = np.full((nbs,), -1, np.int32)
    row[:nb] = warm + take(nb - nb_warm)
    lg = run_chunks(row, matched_tokens, S)

    age0 = float(ags[-1]) if ags is not None else 0.0
    state = {
        "last": torch.zeros((slots,), dtype=torch.int32, device=dev),
        "age": torch.zeros((slots,), dtype=torch.float32, device=dev),
        "step": torch.zeros((slots,), dtype=torch.int32, device=dev),
        "n_emitted": torch.zeros((slots,), dtype=torch.int32, device=dev),
        "max_new": torch.ones((slots,), dtype=torch.int32, device=dev),
        "active": torch.zeros((slots,), dtype=torch.bool, device=dev),
    }
    rows, packed = _fork_rows_core(
        lg[0][None], dv(uniforms[0][None]), dv(np.float32([age0])),
        dv(np.int32([S])), dv(np.int32([max_new])), kn)
    _commit(state, dv(np.int64([0])), rows, 1)

    out_t: List[int] = []
    out_a: List[float] = []
    live = [True]

    def apply(col):
        evt, age, emit, finished = col
        if emit >= 0.5:
            out_t.append(int(evt))
            if cfg.age_encoding:
                out_a.append(float(age))
        if finished >= 0.5:
            live[0] = False

    apply(packed.cpu().numpy()[:, 0])
    pos = S
    tab = np.full((slots, nbs), -1, np.int32)
    table_dirty = True
    while live[0]:
        jb = (pos % W) // bs
        if row[jb] < 0:                    # decode growth, engine order:
            row[jb] = take(1)[0]           # reset positions, then the table
            _reset_pos(cache, [int(row[jb])])
            table_dirty = True
        if table_dirty:
            tab[0] = row
            cache["self"].table.copy_(torch.from_numpy(tab))
            table_dirty = False
        u = np.full((slots, V), 0.5, np.float32)
        u[0] = uniforms[len(out_t)]
        state, packed = _tick_core(wparams, cache, state, dv(u), cfg, kn)
        apply(packed.cpu().numpy()[:, 0])
        pos += 1
    return out_t, out_a
