"""Prefix sharing in the port on the CPU: the refcounted pool, the prefix
index, hold/fork/``sample_futures`` held bit for bit to the port's
``ring_reference_futures`` (ring, paged, prefix-cached paged twice), the
scheduler's edge cases, the zero-leak invariant extended to refcounts
(twins of ``tests/test_prefix.py`` and ``scripts/paged_parity.py``'s fork
storm, in the foreground; the background loop has
``tests/test_torch_engine_loop.py``), and the
port's futures oracle against the JAX package's.

Against JAX the futures are held margin-aware and teacher-forced with a
margin and age tolerance of 2e-3, as in ``tests/test_torch_engine.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import init_delphi
from repro.models import forward as jax_forward
from repro.serve import prefix as jax_prefix
from repro.train import checkpoint as jax_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.parity import check_trajectories, compare_runs
from repro_torch.models import init_params, load_checkpoint
from repro_torch.serve import (BatchedEngine, BlockAllocator,
                               InvalidRequestError, PrefixIndex, Request,
                               RequestCancelledError, RequestTimeoutError,
                               SharedBlockPool, ring_reference_futures)
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import prefix as prefix_mod

torch.set_num_threads(2)

W, BS, K = 64, 16, 4
TOKS = np.asarray([3, 10, 20, 30, 41], np.int32)
AGES = np.linspace(0.0, 30.0, 5).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _setup():
    """The reference tests' geometry: reduced Delphi, V 96, no age cap."""
    cfg = get_config("delphi-2m", reduced=True).replace(
        dtype="float32", vocab_size=96, max_seq_len=48, max_age=1e9)
    return init_params(cfg, seed=7, device="cpu"), cfg


def _engine(params, cfg, **kw):
    return BatchedEngine(params, cfg, device="cpu", **kw)


def _uniforms(n, max_new, V, seed=42):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n, max_new, V)).astype(np.float32)


def _trajs(kids):
    return [(list(k.out_tokens), [np.float32(a) for a in k.out_ages])
            for k in kids]


def _history(S):
    return ((np.arange(3, 3 + S) % 90).astype(np.int32),
            np.linspace(0.0, 30.0, S).astype(np.float32))


def _drained(eng):
    return (eng.allocator.used == 0 and not eng.pool._refs
            and (eng._table == -1).all())


# ---------------------------------------------------------------------------
# SharedBlockPool and PrefixIndex
# ---------------------------------------------------------------------------
def test_shared_pool_refcounts():
    pool = SharedBlockPool(BlockAllocator(8))        # capacity 7
    ids = pool.alloc(3)
    assert pool.used == 3 and all(pool.refcount(i) == 1 for i in ids)
    pool.share(ids)
    assert pool.shared_blocks == 3 and pool.peak_shared == 3
    pool.release(ids)                                # drop one of two refs
    assert pool.used == 3, "a still-referenced block must not free"
    assert pool.shared_blocks == 0
    pool.release(ids)
    assert pool.used == 0 and pool.total_refs == 0
    with pytest.raises(ValueError):
        pool.release(ids)                            # refcount underflow
    with pytest.raises(ValueError):
        pool.share([99])                             # share of unallocated
    assert pool.alloc(8) is None                     # never partial


def test_shared_pool_available_counts_shared_once():
    pool = SharedBlockPool(BlockAllocator(8))
    ids = pool.alloc(4)
    pool.share(ids)                                  # 2 owners, 4 blocks
    assert pool.used == 4                            # counted ONCE
    assert pool.available() == 3                     # free only: no index


def test_prefix_index_chain_and_eviction():
    pool = SharedBlockPool(BlockAllocator(12))
    idx = PrefixIndex(pool, block_size=4, max_entries=8)
    toks = np.arange(10)
    ages = np.linspace(0, 9, 10).astype(np.float32)
    blocks = pool.alloc(3)                           # 2 full + tail
    idx.register(toks, ages, blocks, S=10, age0=9.0, logits=np.zeros(5))
    assert idx.entries == 1 and idx.cached_blocks == 3
    # the chain matches full blocks only, in order, longest prefix
    assert idx.match_prefix(toks, ages) == blocks[:2]
    assert idx.match_prefix(toks[:8], ages[:8]) == blocks[:2]
    assert idx.match_prefix(toks[:4], ages[:4]) == blocks[:1]
    other = toks.copy()
    other[1] = 77
    assert idx.match_prefix(other, ages) == []
    # exact-prompt complete lookup; an age perturbation breaks it
    assert idx.lookup(toks, ages) is not None
    assert idx.lookup(toks, ages + 1.0) is None
    assert idx.lookup(toks[:9], ages[:9]) is None
    pool.release(blocks)             # the request released its refs
    assert pool.used == 3            # the index still holds all three
    assert idx.evictable() == 3
    freed = idx.evict(2)
    assert freed == 3 and idx.entries == 0 and pool.used == 0
    assert idx.match_prefix(toks, ages) == []


def test_prefix_index_lru_cap():
    pool = SharedBlockPool(BlockAllocator(32))
    idx = PrefixIndex(pool, block_size=4, max_entries=2)
    for s in range(3):
        toks = np.arange(8) + 10 * s
        b = pool.alloc(2)
        idx.register(toks, None, b, S=8, age0=0.0)
        pool.release(b)              # only the index holds them
    assert idx.entries == 2          # LRU-capped
    assert idx.evictions == 1
    assert pool.used == 4


@pytest.mark.parametrize("S,bs", [(5, 16), (16, 8), (37, 8), (0, 4)])
def test_prompt_digests_equal_the_jax_package(S, bs):
    """The copied digest chain is byte for byte the JAX package's."""
    toks, ages = _history(S)
    assert prefix_mod.prompt_digests(toks, ages, bs) == \
        jax_prefix.prompt_digests(toks, ages, bs)
    assert prefix_mod.prompt_digests(toks, None, bs) == \
        jax_prefix.prompt_digests(toks, None, bs)


def test_register_failure_takes_no_refs(monkeypatch):
    """``PrefixIndex.register`` builds its entry before sharing the blocks:
    a failure mid-registration leaves no unowned index refs behind."""
    pool = SharedBlockPool(BlockAllocator(8))
    idx = PrefixIndex(pool, block_size=4, max_entries=8)
    blocks = pool.alloc(2)

    def boom(*a, **k):
        raise RuntimeError("entry construction failed")
    monkeypatch.setattr(prefix_mod, "_Entry", boom)
    toks, ages = _history(8)
    with pytest.raises(RuntimeError, match="entry construction failed"):
        idx.register(toks, ages, blocks, S=8, age0=7.0)
    assert idx.entries == 0
    assert pool.total_refs == len(blocks)    # only the caller's own refs
    pool.release(blocks)
    assert pool.used == 0 and not pool._refs


# ---------------------------------------------------------------------------
# Fork parity: engine (ring, paged, prefix-cached paged) == the oracle
# ---------------------------------------------------------------------------
def test_fork_bit_identical_to_oracle():
    """``sample_futures`` through hold/fork/COW reproduces the scheduler-
    free oracle bit for bit (tokens AND fp32 ages): on the ring (row-copy
    fork), on the paged engine (refcounted blocks), and twice on the
    prefix-cached paged engine (the second parent admits by reference, no
    prefill)."""
    params, cfg = _setup()
    n, max_new = 4, 6
    u = _uniforms(n, max_new, cfg.vocab_size)
    ora = [(list(t), [np.float32(a) for a in a_])
           for t, a_ in ring_reference_futures(
               params, cfg, TOKS, AGES, n=n, max_new=max_new, uniforms=u,
               slots=K, max_context=W, device="cpu")]
    assert sum(len(t) for t, _ in ora) >= n
    ring = _engine(params, cfg, slots=K, max_context=W)
    assert _trajs(ring.sample_futures(TOKS, AGES, n=n, max_new=max_new,
                                      uniforms=u)) == ora
    paged = _engine(params, cfg, slots=K, max_context=W, cache="paged",
                    block_size=BS)
    assert _trajs(paged.sample_futures(TOKS, AGES, n=n, max_new=max_new,
                                       uniforms=u)) == ora
    assert paged.pool_stats()["cow_copies"] >= n - 1
    assert _drained(paged)
    pfx = _engine(params, cfg, slots=K, max_context=W, cache="paged",
                  block_size=BS, prefix_cache=True)
    for _ in range(2):
        assert _trajs(pfx.sample_futures(TOKS, AGES, n=n, max_new=max_new,
                                         uniforms=u)) == ora
    st = pfx.pool_stats()
    assert st["prefix_cache"]["hits"] == 1 and st["forks"] == 2
    assert pfx.prefill_shapes == {(1, 8)}       # one prefill for two forks
    pfx.drop_prefix_cache()
    assert _drained(pfx)


def test_generator_sampled_futures_are_reproducible():
    """Generator-sampled forks draw their (kb, V) bootstrap rows and the
    ticks' rows from the engine's ``torch.Generator``: the same seed gives
    the same futures, run to run."""
    params, cfg = _setup()
    outs = []
    for _ in range(2):
        eng = _engine(params, cfg, slots=K, max_context=W, cache="paged",
                      block_size=BS, seed=5)
        kids = eng.sample_futures(TOKS, AGES, n=3, max_new=6)
        assert all(k.done and k.error is None for k in kids)
        outs.append(_trajs(kids))
        assert _drained(eng)
    assert outs[0] == outs[1]
    assert len({tuple(t) for t, _ in outs[0]}) > 1   # futures differ


# ---------------------------------------------------------------------------
# Scheduler edge cases
# ---------------------------------------------------------------------------
def test_cancel_one_of_n_forks_midstream():
    """Cancelling one forked future mid-decode frees only ITS references;
    the siblings finish and every refcount drains."""
    params, cfg = _setup()
    u = _uniforms(3, 40, cfg.vocab_size, seed=3)
    u[:, :, cfg.death_token] = 1e-12     # no future ends before the cancel
    eng = _engine(params, cfg, slots=K, max_context=512, cache="paged",
                  block_size=BS, prefix_cache=True)
    parent = Request(tokens=TOKS, ages=AGES, max_new=40, hold=True,
                     request_id="mc")
    eng.submit(parent)
    kids = eng.fork("mc", 3, uniforms=u)
    for _ in range(3):
        eng.step()                       # the forks decode a while
    assert all(not k.done for k in kids)
    assert eng.cancel("mc/fork-1")
    eng.run()
    assert all(k.done for k in kids)
    assert isinstance(kids[1].error, RequestCancelledError)
    assert kids[0].error is None and kids[2].error is None
    assert len(kids[0].out_tokens) == len(kids[2].out_tokens) == 40
    eng.drop_prefix_cache()
    assert _drained(eng)


def test_preempt_lands_on_fork_and_reacquires_prefix():
    """Pool exhaustion preempts the youngest, a forked future, whose resume
    RE-ACQUIRES the shared prefix through the index by reference."""
    params, cfg = _setup()
    toks, ages = _history(16)            # exactly 2 full blocks at bs 8
    # capacity 6: prefix 2 + three forks' growth blocks exhaust it mid-run;
    # the death token suppressed, every future runs all 12 events
    u = _uniforms(3, 12, cfg.vocab_size, seed=7)
    u[:, :, cfg.death_token] = 1e-12
    eng = _engine(params, cfg, slots=4, max_context=32, cache="paged",
                  block_size=8, blocks=7, prefix_cache=True)
    kids = eng.sample_futures(toks, ages, n=3, max_new=12, uniforms=u)
    assert all(k.done and k.error is None for k in kids)
    assert [len(k.out_tokens) for k in kids] == [12, 12, 12]
    assert eng.preemptions > 0
    assert eng.pool_stats()["prefix_cache"]["partial_hits"] > 0, \
        "the resumed fork must re-acquire its prefix by reference"
    eng.drop_prefix_cache()
    assert _drained(eng)


def test_over_width_prompt_bypasses_prefix_index():
    """S > max_context histories wrap the ring: they neither register in
    nor borrow from the index, and their fork still matches the ring."""
    params, cfg = _setup()
    toks, ages = _history(40)
    u = _uniforms(2, 4, cfg.vocab_size, seed=17)
    eng = _engine(params, cfg, slots=2, max_context=32, cache="paged",
                  block_size=8, prefix_cache=True)
    kids = eng.sample_futures(toks, ages, n=2, max_new=4, uniforms=u)
    assert eng.prefix.entries == 0 and eng.prefix.hits == 0
    ring = _engine(params, cfg, slots=2, max_context=32)
    assert _trajs(kids) == _trajs(ring.sample_futures(
        toks, ages, n=2, max_new=4, uniforms=u))
    assert all(k.out_tokens for k in kids)
    assert _drained(eng)


def test_shared_admission_budget_counts_block_once():
    """N futures co-reside in a pool far smaller than N unshared copies:
    the admission budget charges a shared block once."""
    params, cfg = _setup()
    toks, ages = _history(17)            # 3 blocks at bs 8 (2 full + tail)
    # capacity 6 < 3 unshared copies (9 blocks); shared: 3 + 3 tails = 6
    eng = _engine(params, cfg, slots=4, max_context=32, cache="paged",
                  block_size=8, blocks=7, prefix_cache=True)
    kids = eng.sample_futures(toks, ages, n=3, max_new=3)
    assert all(k.done and k.error is None for k in kids)
    assert eng.peak_active == 3
    assert eng.preemptions == 0
    assert eng.allocator.peak_used <= 6
    assert eng.pool.peak_shared >= 2


def test_pinned_hits_budget_is_honest():
    """Prefix hits do not double as eviction headroom: requests whose hits
    are the pool's cached blocks admit on free blocks alone (one at a time
    here), and the shared entry survives to serve every one."""
    params, cfg = _setup()
    toks1, ages1 = _history(16)
    toks2 = np.concatenate([toks1, np.arange(50, 58) % 90]).astype(np.int32)
    ages2 = np.concatenate([ages1,
                            np.linspace(31, 40, 8)]).astype(np.float32)
    eng = _engine(params, cfg, slots=4, max_context=32, cache="paged",
                  block_size=8, blocks=5, prefix_cache=True)
    eng.submit(Request(tokens=toks1, ages=ages1, max_new=2))
    eng.run()
    assert eng.prefix.entries == 1       # 2 cached full blocks, 2 free
    rs = [Request(tokens=toks2.copy(), ages=ages2.copy(), max_new=4)
          for _ in range(3)]
    for r in rs:
        eng.submit(r)
    eng.run(max_ticks=2000)
    assert all(r.done and r.error is None for r in rs)
    assert all(len(r.out_tokens) == 4 for r in rs)
    st = eng.pool_stats()["prefix_cache"]
    assert st["partial_hits"] >= 3
    assert st["evictions"] == 0
    eng.drop_prefix_cache()
    assert _drained(eng)


@pytest.mark.parametrize("kind", ["ring", "paged", "mamba2"])
def test_hold_survives_ticks_with_other_traffic(kind):
    """A parent parked across ticks of unrelated decode traffic forks the
    SAME bits as an immediate fork: its parked writes (masked in the ring
    copy, sent to the trash block when paged) never reach the children, and
    a recurrent model's children start from the parent's state as admitted,
    not from the row the parked ticks advanced (the JAX package's engine
    forks the advanced row: its children differ from an immediate fork's)."""
    n, max_new = 2, 5
    if kind == "mamba2":
        cfg = get_config("mamba2-780m", reduced=True).replace(
            dtype="float32")
        params = init_params(cfg, seed=0, device="cpu")
        toks, ages, kw = TOKS * 7, None, {}
        other = Request(tokens=toks[:3] + 1, max_new=8)
    else:
        params, cfg = _setup()
        toks, ages, kw = TOKS, AGES, {"cache": kind, "block_size": BS}
        other = Request(tokens=TOKS[:3], ages=AGES[:3], max_new=8)
    other.uniforms = _uniforms(1, 8, cfg.vocab_size, 31)[0]
    u = _uniforms(n, max_new, cfg.vocab_size, seed=29)
    ref = _trajs(_engine(params, cfg, slots=K, max_context=W,
                         **kw).sample_futures(toks, ages, n=n,
                                              max_new=max_new, uniforms=u))
    eng = _engine(params, cfg, slots=K, max_context=W, **kw)
    parent = Request(tokens=toks, ages=ages, max_new=max_new, hold=True)
    eng.submit(parent)
    eng.submit(other)
    for _ in range(4):                   # the parent parks, other decodes
        eng.step()
    assert len(other.out_tokens) >= 4 and not parent.done
    kids = eng.fork(parent.request_id, n, uniforms=u, max_new=max_new)
    eng.run()
    if kind == "mamba2":                 # a generic LM runs its budget
        assert all(len(k.out_tokens) == max_new for k in kids)
    assert _trajs(kids) == ref, f"held-parent fork diverged ({kind})"


def test_fork_validation_and_ring_refuses_prefix():
    params, cfg = _setup()
    with pytest.raises(ValueError, match="prefix_cache requires"):
        _engine(params, cfg, cache="ring", prefix_cache=True)
    eng = _engine(params, cfg, slots=2, max_context=W, cache="paged",
                  block_size=BS)
    with pytest.raises(InvalidRequestError, match="unknown or finished"):
        eng.fork("nope", 2)
    r = Request(tokens=TOKS, ages=AGES, max_new=4)
    eng.submit(r)
    with pytest.raises(InvalidRequestError, match="hold=True parent"):
        eng.fork(r.request_id, 2)
    with pytest.raises(InvalidRequestError, match="fork uniforms"):
        eng.sample_futures(TOKS, AGES, n=2, max_new=4,
                           uniforms=np.zeros((1, 4, cfg.vocab_size)))
    eng.run()
    assert _drained(eng)


def test_cancelled_parent_fails_children():
    params, cfg = _setup()
    eng = _engine(params, cfg, slots=2, max_context=W, cache="paged",
                  block_size=BS)
    parent = Request(tokens=TOKS, ages=AGES, max_new=4, hold=True,
                     request_id="doomed")
    eng.submit(parent)
    kids = eng.fork("doomed", 2)
    assert eng.cancel("doomed")
    eng.run(max_ticks=200)
    assert parent.done and isinstance(parent.error, RequestCancelledError)
    assert all(k.done and isinstance(k.error, RequestCancelledError)
               for k in kids)
    assert _drained(eng)


def test_pool_stats_sharing_fields():
    params, cfg = _setup()
    eng = _engine(params, cfg, slots=2, max_context=W, cache="paged",
                  block_size=BS, prefix_cache=True)
    st = eng.pool_stats()
    for key in ("shared_blocks", "shared_blocks_peak", "cow_copies",
                "forks", "prefix_cache", "blocks_peak_used"):
        assert key in st
    assert st["prefix_cache"]["entries"] == 0
    ring = _engine(params, cfg, slots=2, max_context=W)
    assert "shared_blocks" not in ring.pool_stats()
    assert ring.pool_stats()["forks"] == 0


# ---------------------------------------------------------------------------
# Failures between acquire and hand-over strand no reference
# ---------------------------------------------------------------------------
def test_admission_alloc_crash_releases_shared_hits(monkeypatch):
    """Prefix hits are shared BEFORE the suffix alloc; if the alloc raises,
    the admission's cleanup drops those shares and the retry is served."""
    params, cfg = _setup()
    toks1, ages1 = _history(16)          # exactly 2 full blocks at bs 8
    toks2 = np.concatenate([toks1, np.arange(50, 58) % 90]).astype(np.int32)
    ages2 = np.concatenate([ages1,
                            np.linspace(31, 40, 8)]).astype(np.float32)
    eng = _engine(params, cfg, slots=4, max_context=32, cache="paged",
                  block_size=8, blocks=7, prefix_cache=True)
    eng.submit(Request(tokens=toks1, ages=ages1, max_new=2))
    eng.run()
    assert eng.prefix.entries == 1
    real_alloc = eng.pool.alloc
    armed = {"on": True}

    def flaky_alloc(n):
        if armed["on"]:
            armed["on"] = False
            raise RuntimeError("injected alloc failure")
        return real_alloc(n)
    monkeypatch.setattr(eng.pool, "alloc", flaky_alloc)
    r2 = Request(tokens=toks2, ages=ages2, max_new=2)
    eng.submit(r2)
    with pytest.raises(RuntimeError, match="injected alloc failure"):
        eng.run()
    # the crashed admission's shares are gone: only the index holds refs
    assert eng.pool.used == 2 and eng.pool.total_refs == 2
    done = eng.run()
    assert r2 in done and r2.error is None and len(r2.out_tokens) == 2
    assert eng.pool_stats()["prefix_cache"]["partial_hits"] >= 1
    eng.drop_prefix_cache()
    assert _drained(eng)


def test_cow_failure_mid_fork_leaks_no_blocks(monkeypatch):
    """A copy-on-write that fails after its destination block was taken
    releases that block; the tick raises, and the next run retries the copy
    and drains the pool to zero."""
    params, cfg = _setup()
    real = engine_mod._cow_block
    fired = {"on": False}

    def flaky(*a, **k):
        if not fired["on"]:
            fired["on"] = True
            raise RuntimeError("injected COW failure")
        return real(*a, **k)
    monkeypatch.setattr(engine_mod, "_cow_block", flaky)
    eng = _engine(params, cfg, slots=K, max_context=W, cache="paged",
                  block_size=BS)
    parent = Request(tokens=TOKS, ages=AGES, max_new=5, hold=True,
                     request_id="cow")
    eng.submit(parent)
    kids = eng.fork("cow", 2, uniforms=_uniforms(2, 5, cfg.vocab_size))
    with pytest.raises(RuntimeError, match="injected COW failure"):
        eng.step()
    assert fired["on"], "the fork's first write must have copied a block"
    # the failed copy's block went back: one tail block, shared by the kids
    assert eng.allocator.used == 1 and eng.pool.shared_blocks == 1
    eng.run()
    assert all(k.done and k.error is None for k in kids)
    assert _drained(eng)


def test_fork_cancel_timeout_storm_leaks_nothing():
    """``scripts/paged_parity.py``'s fork storm in the foreground: six
    futures fan-outs on an undersized prefix-cached pool (preemption,
    COW, index eviction), one child of every other fan-out cancelled
    mid-flight, then fan-outs whose deadline has passed.  Refcounts drain,
    the index empties, no block leaks, every table entry is empty."""
    params, cfg = _setup()
    eng = _engine(params, cfg, slots=4, max_context=32, cache="paged",
                  block_size=8, blocks=8, prefix_cache=True, seed=3)
    kids = []
    for w in range(6):
        S = 3 + (w % 3)
        parent = Request(
            tokens=(np.arange(3, 3 + S, dtype=np.int32) + w) % 90,
            ages=np.linspace(0.0, 30.0, S).astype(np.float32), max_new=10,
            hold=True, request_id=f"fut-{w}")
        eng.submit(parent)
        kids += eng.fork(parent.request_id, 3)
    for _ in range(3):
        eng.step()
    flagged = sum(eng.cancel(f"fut-{w}/fork-1") for w in range(0, 6, 2))
    eng.run(max_ticks=4000)
    assert all(k.done for k in kids)
    assert all(k.error is None or isinstance(k.error, RequestCancelledError)
               for k in kids)
    assert sum(isinstance(k.error, RequestCancelledError)
               for k in kids) == flagged >= 1
    st = eng.pool_stats()
    assert st["forks"] == 6 and st["cow_copies"] > 0
    eng.drop_prefix_cache()
    assert eng.prefix.entries == 0
    assert _drained(eng)

    late = _engine(params, cfg, slots=2, max_context=32, cache="paged",
                   block_size=8, request_timeout=0.0, prefix_cache=True)
    parent = Request(tokens=np.arange(3, 8, dtype=np.int32),
                     ages=np.linspace(0.0, 30.0, 5).astype(np.float32),
                     max_new=10, hold=True)
    late.submit(parent)
    kids2 = late.fork(parent.request_id, 3)
    late.run(max_ticks=200)
    assert all(k.done and isinstance(k.error, RequestTimeoutError)
               for k in kids2)
    late.drop_prefix_cache()
    assert _drained(late)


# ---------------------------------------------------------------------------
# Against the JAX package's oracle
# ---------------------------------------------------------------------------
def test_port_futures_oracle_vs_jax_oracle(tmp_path):
    """The two packages' ``ring_reference_futures`` from one npz (the JAX
    package's checkpoint) and the same uniforms: the port's futures are
    held step by step against the JAX model on their own prefixes (margin
    and age tolerance 2e-3), and agree with JAX's event for event up to
    each future's first divergence (ages within 0.25 relative)."""
    jcfg = jax_config("delphi-2m", reduced=True).replace(dtype="float32")
    cfg = get_config("delphi-2m", reduced=True).replace(dtype="float32")
    jp = init_delphi(jcfg, jax.random.PRNGKey(6))
    jax_checkpoint.save(str(tmp_path), jp, jcfg)
    params = load_checkpoint(str(tmp_path), cfg, "cpu")
    rng = np.random.default_rng(8)
    n, max_new = 4, 10
    toks = rng.integers(3, cfg.vocab_size, 21).astype(np.int32)
    ages = np.sort(rng.uniform(50, 75, 21)).astype(np.float32)
    u = rng.random((n, max_new, cfg.vocab_size), dtype=np.float32)
    theirs = jax_prefix.ring_reference_futures(
        jp, jcfg, toks, ages, n=n, max_new=max_new, uniforms=u, slots=K,
        max_context=W)
    mine = ring_reference_futures(params, cfg, toks, ages, n=n,
                                  max_new=max_new, uniforms=u, slots=K,
                                  max_context=W, device="cpu")
    assert sum(len(t) for t, _ in mine) >= n
    jf = jax.jit(lambda t, a: jax_forward(jp, jcfg, {"tokens": t,
                                                    "ages": a})["logits"])
    held = check_trajectories(
        [(toks, ages)] * n, mine, list(u),
        lambda t, a: np.asarray(jf(jnp.asarray(t, jnp.int32),
                                   jnp.asarray(a))),
        margin_tol=2e-3, age_rtol=2e-3, max_age=cfg.max_age,
        death_token=cfg.death_token, max_context=W)
    assert held["steps"] == sum(len(t) for t, _ in mine)
    free = compare_runs([(list(t), list(a)) for t, a in theirs], mine,
                        age_rtol=0.25)
    assert free["compared"] >= n
