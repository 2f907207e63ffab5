"""The port's paged ``BatchedEngine`` on the CPU: ring == paged bit for bit,
free-block admission, preemption, cancellation and timeouts with no leaked
block, one host sync per tick (twins of ``tests/test_paged_engine.py``
and of ``scripts/paged_parity.py``'s storm), and the port's paged engine
against the JAX package's.

Inside the port the comparisons are exact (tokens and fp32 ages).  Against
JAX, trajectories are held margin-aware and teacher-forced
(``repro_torch.core.parity``) with a margin and age tolerance of 2e-3, as in
``tests/test_torch_engine.py`` (the waiting-time disagreement measured
there is < 6e-4).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import init_delphi
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import make_paged_decode_cache as jax_make_paged
from repro.models import mask_padded_positions as jax_mask
from repro.serve import BatchedEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve.engine import _insert_blocks_jit as jax_insert_blocks
from repro.train import checkpoint as jax_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.parity import (check_trajectories, compare_runs,
                                     port_logits_fn)
from repro_torch.launch import serve as launch
from repro_torch.models import (decode_step, forward, init_params,
                                load_checkpoint, make_paged_decode_cache,
                                mask_padded_positions, to_flat_numpy)
from repro_torch.serve import (BatchedEngine, BlockAllocator,
                               InvalidRequestError, Request,
                               RequestCancelledError, RequestTimeoutError)
from repro_torch.serve import engine as engine_mod

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _setup():
    """The reference tests' geometry: reduced Delphi, V 96, no age cap."""
    cfg = get_config("delphi-2m", reduced=True).replace(
        dtype="float32", vocab_size=96, max_seq_len=48, max_age=1e9)
    return init_params(cfg, seed=7, device="cpu"), cfg


def _uniforms(max_new, V, seed=42):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(max_new, V)).astype(np.float32)


def _req(s, max_new=8, uniforms=None, request_id=None):
    S = 3 + (s % 4)
    return Request(tokens=(np.arange(3, 3 + S, dtype=np.int32) + s) % 90,
                   ages=np.linspace(0.0, 30.0, S).astype(np.float32),
                   max_new=max_new, uniforms=uniforms, request_id=request_id)


def _jax_params(params):
    """The JAX model's nested parameter dict from the port's weights."""
    out = {}
    for key, arr in to_flat_numpy(params).items():
        node = out
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arr)
    return out


def _engine(params, cfg, **kw):
    return BatchedEngine(params, cfg, device="cpu", **kw)


def _drained(eng):
    return (eng.allocator.used == 0 and not eng.pool._refs
            and (eng._table == -1).all())


# ---------------------------------------------------------------------------
# Allocator and configuration
# ---------------------------------------------------------------------------
def test_allocator_free_list():
    a = BlockAllocator(6)               # capacity 5, block 0 reserved
    assert (a.capacity, a.free, a.used) == (5, 5, 0)
    ids = a.alloc(3)
    assert len(ids) == 3 and 0 not in ids
    assert a.alloc(3) is None           # never partial
    assert a.used == 3 and a.peak_used == 3
    a.release(ids)
    assert a.used == 0 and a.free == 5
    with pytest.raises(ValueError):
        a.release([0])                  # the trash block is not allocatable
    with pytest.raises(RuntimeError):
        a.release(ids + [1, 2])         # over-free detected


def test_engine_rejects_bad_paged_config():
    params, cfg = _setup()
    with pytest.raises(ValueError, match="multiple"):
        _engine(params, cfg, max_context=50, cache="paged", block_size=16)
    with pytest.raises(ValueError, match="one full slot"):
        _engine(params, cfg, max_context=64, cache="paged", block_size=16,
                blocks=3)
    with pytest.raises(ValueError, match="'ring' or 'paged'"):
        _engine(params, cfg, cache="dense")


# ---------------------------------------------------------------------------
# Ring parity
# ---------------------------------------------------------------------------
def _run(params, cfg, kind, reqs, **kw):
    eng = _engine(params, cfg, slots=2, max_context=64, cache=kind, **kw)
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    assert len(done) == len(reqs)
    return eng, [(r.out_tokens, r.out_ages) for r in done]


def test_paged_bit_identical_to_ring_generate():
    """Same slots, same injected uniforms: the paged engine's trajectories
    (tokens AND fp32 ages) equal the ring engine's bit for bit."""
    params, cfg = _setup()
    u = _uniforms(8, cfg.vocab_size)
    _, ring = _run(params, cfg, "ring", [_req(s, uniforms=u)
                                         for s in range(5)])
    eng, paged = _run(params, cfg, "paged", [_req(s, uniforms=u)
                                             for s in range(5)],
                      block_size=16)
    assert ring == paged
    assert sum(len(t) for t, _ in paged) >= 5
    assert _drained(eng)


@pytest.mark.parametrize("block_size", [4, 8])
def test_paged_bit_identical_over_width_prompt(block_size):
    """S > max_context: the wrapped ring pack goes through the block copy
    and decodes identically (solo exact-shape admission in both)."""
    params, cfg = _setup()
    S, W = 33, 16
    toks = (np.arange(3, 3 + S) % 90).astype(np.int32)
    ages = np.linspace(0.0, 30.0, S).astype(np.float32)
    u = _uniforms(4, cfg.vocab_size, seed=13)
    outs = []
    for kw in ({}, {"cache": "paged", "block_size": block_size}):
        eng = _engine(params, cfg, slots=1, max_context=W, **kw)
        r = Request(tokens=toks, ages=ages, max_new=4, uniforms=u)
        eng.submit(r)
        eng.run()
        assert r.done and r.error is None and r.out_tokens
        outs.append((r.out_tokens, r.out_ages))
    assert outs[0] == outs[1]
    assert _drained(eng)


# ---------------------------------------------------------------------------
# Scheduler: free-block admission, growth, preemption
# ---------------------------------------------------------------------------
def test_admission_budgeted_by_free_blocks():
    """A pool below slots x context admits what fits and queues the rest;
    short requests still share the pool."""
    params, cfg = _setup()
    # capacity 5 blocks of 8 tokens; 4 slots x 32 context would need 16
    eng = _engine(params, cfg, slots=4, max_context=32, cache="paged",
                  block_size=8, blocks=6)
    for s in range(6):
        eng.submit(_req(s, max_new=4))
    done = eng.run(max_ticks=2000)
    assert len(done) == 6
    assert eng.allocator.peak_used <= 5
    assert eng.peak_active >= 2
    assert _drained(eng)


def test_preemption_on_pool_exhaustion():
    """Decode growth past the pool preempts the youngest request (requeued,
    resumed by recompute) instead of deadlocking; nothing leaks."""
    params, cfg = _setup()
    eng = _engine(params, cfg, slots=4, max_context=32, cache="paged",
                  block_size=8, blocks=6)
    for s in range(8):
        eng.submit(_req(s, max_new=10))
    done = eng.run(max_ticks=4000)
    assert len(done) == 8
    for r in done:
        assert r.error is None
        assert (len(r.out_tokens) == 10
                or r.out_tokens[-1] == cfg.death_token)
        assert len(r.out_ages) == len(r.out_tokens)
        assert all(b >= a for a, b in zip(r.out_ages, r.out_ages[1:]))
    assert eng.preemptions > 0
    assert _drained(eng)


def test_preempted_injected_request_resumes_uniform_rows(monkeypatch):
    """A preempted injected request samples event i from uniform row i
    across the preemption: its resume re-prefills the history and the
    events so far, and takes row len(out_tokens) (not row 0).  Every step
    of every trajectory is held against the port's own model on its own
    prefix under row i; a margin of 1e-4 covers the CPU's prefill-vs-decode
    rounding (~1e-6)."""
    params, cfg = _setup()
    max_new = 10
    us = [_uniforms(max_new, cfg.vocab_size, seed=11 + s) for s in range(4)]
    for u in us:
        u[:, cfg.death_token] = 1e-12      # every request runs all 10 rows
    reqs = [_req(s, max_new=max_new, uniforms=us[s]) for s in range(4)]
    resumed = []
    real = engine_mod.BatchedEngine._admit_group_inner

    def spy(self, group, slot_ids, injected):
        resumed.extend(r for r in group if r.out_tokens)
        return real(self, group, slot_ids, injected)
    monkeypatch.setattr(engine_mod.BatchedEngine, "_admit_group_inner", spy)
    eng = _engine(params, cfg, slots=4, max_context=32, cache="paged",
                  block_size=8, blocks=6)
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=4000)
    assert eng.preemptions > 0 and resumed
    assert all(r.done and r.error is None for r in reqs)
    assert all(len(r.out_tokens) == max_new for r in reqs)
    held = check_trajectories(
        [(r.tokens, r.ages) for r in reqs],
        [(r.out_tokens, r.out_ages) for r in reqs], us,
        port_logits_fn(params, cfg), margin_tol=1e-4, age_rtol=1e-4,
        max_age=cfg.max_age, death_token=cfg.death_token, max_context=32)
    assert held["steps"] == 4 * max_new
    assert _drained(eng)


# ---------------------------------------------------------------------------
# Cancellation and timeouts free blocks
# ---------------------------------------------------------------------------
def test_cancel_pending_and_inflight():
    params, cfg = _setup()
    eng = _engine(params, cfg, slots=2, max_context=32, cache="paged",
                  block_size=8)
    rs = [_req(s, max_new=28, request_id=f"r{s}") for s in range(4)]
    for r in rs:
        eng.submit(r)
    eng.step()                          # admit r0/r1; r2/r3 pending
    assert eng.cancel("r0")             # in flight
    assert eng.cancel("r3")             # pending
    assert not eng.cancel("unknown-id")
    eng.run(max_ticks=2000)
    assert isinstance(rs[0].error, RequestCancelledError)
    assert isinstance(rs[3].error, RequestCancelledError)
    assert rs[1].error is None and rs[2].error is None
    assert rs[0] not in eng.completed and rs[3] not in eng.completed
    assert _drained(eng)
    assert not eng.cancel("r0")         # already finished


def test_request_timeout_frees_blocks():
    params, cfg = _setup()
    eng = _engine(params, cfg, slots=2, max_context=32, cache="paged",
                  block_size=8, request_timeout=0.0)
    r = _req(0, max_new=20)
    eng.submit(r)
    eng.run(max_ticks=100)
    assert r.done and isinstance(r.error, RequestTimeoutError)
    assert _drained(eng)


def test_cancel_preempt_timeout_storm_leaks_nothing():
    """``scripts/paged_parity.py``'s storm in the foreground: an undersized
    pool (capacity 5, a full slot needs 4) under constant growth pressure,
    with a third of the requests cancelled mid-flight, then a batch whose
    deadline has passed.  Zero leaked blocks, refcounts drained, every
    table entry empty."""
    params, cfg = _setup()
    eng = _engine(params, cfg, slots=4, max_context=32, cache="paged",
                  block_size=8, blocks=6)
    reqs = []
    for s in range(24):
        S = 3 + (s % 5)
        r = Request(tokens=(np.arange(3, 3 + S, dtype=np.int32)) % 90,
                    ages=np.linspace(0.0, 30.0, S).astype(np.float32),
                    max_new=12, request_id=f"storm-{s}")
        reqs.append(r)
        eng.submit(r)
    for _ in range(6):
        eng.step()
    flagged = sum(eng.cancel(r.request_id)
                  for i, r in enumerate(reqs) if i % 3 == 0)
    eng.run(max_ticks=4000)
    assert all(r.done for r in reqs)
    n_cancelled = sum(isinstance(r.error, RequestCancelledError)
                      for r in reqs)
    assert n_cancelled == flagged >= 4
    assert all(r.error is None or isinstance(r.error, RequestCancelledError)
               for r in reqs)
    assert eng.preemptions > 0
    assert _drained(eng)

    late = _engine(params, cfg, slots=2, max_context=32, cache="paged",
                   block_size=8, request_timeout=0.0)
    rs = [Request(tokens=np.arange(3, 8, dtype=np.int32),
                  ages=np.linspace(0.0, 30.0, 5).astype(np.float32),
                  max_new=12) for _ in range(3)]
    for r in rs:
        late.submit(r)
    late.run(max_ticks=200)
    assert all(isinstance(r.error, RequestTimeoutError) for r in rs)
    assert _drained(late)


# ---------------------------------------------------------------------------
# Host syncs, failures, ids, stats
# ---------------------------------------------------------------------------
def test_paged_keeps_one_host_sync_per_tick(monkeypatch):
    """Tables, the allocator and the position mirror live on the host: the
    paged engine still makes exactly ONE packed copy per tick and per
    admission batch, and reads no other device value on the host."""
    params, cfg = _setup()
    copies = []
    real = engine_mod._to_host
    monkeypatch.setattr(engine_mod, "_to_host",
                        lambda x: copies.append(x.shape) or real(x))

    def no_sync(*a, **k):
        raise AssertionError("a device value was read on the host")
    for name in ("item", "tolist", "__bool__", "__float__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, no_sync)
    eng = _engine(params, cfg, slots=2, max_context=64, cache="paged",
                  block_size=16)
    for s in range(5):
        eng.submit(_req(s, max_new=4))
    done = eng.run()
    fut = _engine(params, cfg, slots=4, max_context=64, cache="paged",
                  block_size=16, prefix_cache=True)
    kids = fut.sample_futures(np.arange(3, 20, dtype=np.int32),
                              np.linspace(0.0, 30.0, 17).astype(np.float32),
                              n=3, max_new=4)
    kids += fut.sample_futures(np.arange(3, 20, dtype=np.int32),
                               np.linspace(0.0, 30.0, 17).astype(np.float32),
                               n=3, max_new=4)
    monkeypatch.undo()
    assert len(done) == 5 and all(k.done and k.error is None for k in kids)
    assert len(copies) == eng.host_syncs + fut.host_syncs
    for e in (eng, fut):
        assert e.host_syncs == e.ticks + e.admit_batches
    assert all(s[0] == 4 for s in copies)
    assert fut.prefix.hits == 1         # the second parent admitted by ref


def test_admission_crash_releases_blocks(monkeypatch):
    """A failure mid-admission (after blocks were allocated, before the
    cohort landed in slots) returns the blocks and puts the cohort back on
    the queue; the next run serves it."""
    params, cfg = _setup()
    eng = _engine(params, cfg, slots=2, max_context=32, cache="paged",
                  block_size=8)

    def boom(*a, **k):
        raise RuntimeError("injected insert failure")
    monkeypatch.setattr(engine_mod, "_insert_blocks", boom)
    rs = [_req(s, max_new=4) for s in range(2)]
    for r in rs:
        eng.submit(r)
    with pytest.raises(RuntimeError, match="injected"):
        eng.step()
    assert eng.allocator.used == 0 and not eng.pool._refs
    assert eng.pending == rs
    monkeypatch.undo()
    eng.run()
    assert all(r.done and r.error is None for r in rs)
    assert _drained(eng)


def test_duplicate_request_id_rejected():
    params, cfg = _setup()
    eng = _engine(params, cfg, slots=2, max_context=32, cache="paged",
                  block_size=8)
    eng.submit(_req(0, request_id="dup"))
    with pytest.raises(InvalidRequestError, match="already in flight"):
        eng.submit(_req(1, request_id="dup"))
    eng.run(max_ticks=500)
    eng.submit(_req(2, request_id="dup"))   # the id is free again
    eng.run(max_ticks=500)
    assert _drained(eng)


def test_pool_stats_shape():
    params, cfg = _setup()
    eng = _engine(params, cfg, slots=2, max_context=32, cache="paged",
                  block_size=8)
    st = eng.pool_stats()
    assert st["cache"] == "paged" and st["blocks"] == 9
    assert st["cache_bytes"] == eng.cache_bytes > 0
    assert st["prefill_chunk_tokens"] is None
    assert st["chunked_prefills"] == st["prefill_in_progress"] == 0
    ring = _engine(params, cfg, slots=2, max_context=32)
    assert ring.pool_stats()["cache"] == "ring"
    # the default pool is dense-equivalent: the ring's K/V bytes
    assert eng.allocator.capacity == 2 * (32 // 8)
    kv = sum(t.numel() * t.element_size() for t in eng.cache["self"][:2])
    ring_kv = sum(t.numel() * t.element_size()
                  for t in ring.cache["self"][:2])
    assert kv == ring_kv * 9 // 8       # plus the trash block


def test_paged_serve_cli_on_cpu(capsys):
    out = launch.main(["--arch", "delphi-2m", "--requests", "3", "--slots",
                       "2", "--max-new", "4", "--cache", "paged",
                       "--device", "cpu"])
    eng = out["engine"]
    assert eng.paged and len(out["done"]) == 3
    assert eng.host_syncs == eng.ticks + eng.admit_batches
    assert eng.allocator.used == 0
    assert "served 3 requests" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Against the JAX package: the paged decode, and the paged engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [True, False],
                         ids=["delphi-2m-reduced", "delphi-2m"])
def test_paged_decode_step_vs_jax(reduced):
    """Prefill rows copied into pool blocks scattered over the pool (the
    JAX package's ``_insert_blocks_jit`` and the port's ``_insert_blocks``),
    then ``decode_step`` on the paged caches, each row at its own depth:
    logits within 2e-3 and position planes equal, step by step (the
    tolerance of ``tests/test_torch_model.py``, measured there: < 8e-4).
    The JAX decode defers its write and merges the new token; the port's
    writes first and reads it back through the table."""
    cfg = get_config("delphi-2m", reduced=reduced).replace(dtype="float32")
    jcfg = jax_config("delphi-2m", reduced=reduced).replace(dtype="float32")
    params = init_params(cfg, seed=1, device="cpu")
    jp = _jax_params(params)
    rng = np.random.default_rng(6)
    B, S, W, bs, steps = 3, 20, 32, 8, 4
    nbs, NB = W // bs, 1 + B * (W // bs) + 2
    toks = rng.integers(3, cfg.vocab_size, (B, S)).astype(np.int32)
    ages = np.sort(rng.uniform(30, 84, (B, S)), axis=1).astype(np.float32)
    last = np.array([S - 1, 9, 14], np.int32)
    jo = jax_forward(jp, jcfg, {"tokens": jnp.asarray(toks),
                                "ages": jnp.asarray(ages)}, mode="prefill",
                     cache_width=W, last_index=jnp.asarray(last))
    to = forward(params, cfg, {"tokens": torch.from_numpy(toks),
                               "ages": torch.from_numpy(ages)},
                 mode="prefill", cache_width=W,
                 last_index=torch.from_numpy(last))
    jrows = jax_mask(jo["cache"], jnp.asarray(last))
    trows = mask_padded_positions(to["cache"], torch.from_numpy(last))
    # every row's blocks through its last decode position, scattered; the
    # rest of each table -1
    perm = rng.permutation(np.arange(1, NB))
    table = np.full((B, nbs), -1, np.int32)
    nblk = -(-S // bs)
    for b in range(B):
        need = -(-(int(last[b]) + 1 + steps) // bs)
        table[b, :need] = perm[b * nbs:b * nbs + need]
    dst = table[:, :nblk].copy()
    dst[dst < 0] = 0
    jc = jax_make_paged(jcfg, B, W, num_blocks=NB, block_size=bs)
    jc = jax_insert_blocks(jc, jrows, jnp.asarray(dst), nblk=nblk)
    jc = {"self": jc["self"]._replace(table=jnp.asarray(table))}
    tc = make_paged_decode_cache(params, cfg, B, W, num_blocks=NB,
                                 block_size=bs)
    engine_mod._insert_blocks(tc, trows, torch.from_numpy(dst).long(), B,
                              nblk)
    tc["self"].table.copy_(torch.from_numpy(table))
    # the positions past each row's prompt went to the blocks too (-1): a
    # fresh block for them would be reset, as the engine does
    np.testing.assert_array_equal(tc["self"].pos.numpy(),
                                  np.asarray(jc["self"].pos))
    jdec = jax.jit(functools.partial(jax_decode_step, cfg=jcfg))
    age = ages[np.arange(B), last]
    step = last + 1
    for i in range(steps):
        tok = rng.integers(3, cfg.vocab_size, (B, 1)).astype(np.int32)
        age = (age + rng.uniform(0.01, 2.0, B)).astype(np.float32)
        jd = jdec(jp, cache=jc, batch={"tokens": jnp.asarray(tok),
                                       "ages": jnp.asarray(age[:, None])},
                  step=jnp.asarray(step))
        td = decode_step(params, cfg, tc,
                         {"tokens": torch.from_numpy(tok),
                          "ages": torch.from_numpy(age[:, None])},
                         torch.from_numpy(step))
        np.testing.assert_allclose(td["logits"].numpy(),
                                   np.asarray(jd["logits"]), atol=2e-3,
                                   err_msg=f"decode step {i}")
        jc, tc = jd["cache"], td["cache"]
        np.testing.assert_array_equal(tc["self"].pos.numpy(),
                                      np.asarray(jc["self"].pos))
        step = step + 1


# ---------------------------------------------------------------------------
# Against the JAX package's paged engine
# ---------------------------------------------------------------------------
def test_port_paged_engine_vs_jax_paged_engine(tmp_path):
    """Both paged engines from one npz (the JAX package's checkpoint), the
    same prompts and injected uniforms.  The port's trajectories are held
    step by step against the JAX model on their own prefixes (margin and
    age tolerance 2e-3), and the two runs agree event for event up to each
    request's first divergence (ages within 0.25 relative before it)."""
    jcfg = jax_config("delphi-2m", reduced=True).replace(dtype="float32")
    cfg = get_config("delphi-2m", reduced=True).replace(dtype="float32")
    jp = init_delphi(jcfg, jax.random.PRNGKey(5))
    jax_checkpoint.save(str(tmp_path), jp, jcfg)
    params = load_checkpoint(str(tmp_path), cfg, "cpu")
    rng = np.random.default_rng(4)
    max_new, W = 12, 64
    reqs = []
    for _ in range(8):
        S = int(rng.integers(2, 30))
        reqs.append((rng.integers(3, cfg.vocab_size, S).astype(np.int32),
                     np.sort(rng.uniform(50, 75, S)).astype(np.float32),
                     rng.random((max_new, cfg.vocab_size), dtype=np.float32)))
    jeng = JaxEngine(jp, jcfg, slots=4, max_context=W, cache="paged",
                     block_size=16)
    jrs = [JaxRequest(tokens=t, ages=a, max_new=max_new, uniforms=u)
           for t, a, u in reqs]
    for r in jrs:
        jeng.submit(r)
    jeng.run()
    eng = _engine(params, cfg, slots=4, max_context=W, cache="paged",
                  block_size=16)
    rs = [Request(tokens=t, ages=a, max_new=max_new, uniforms=u)
          for t, a, u in reqs]
    for r in rs:
        eng.submit(r)
    eng.run()
    assert all(r.done and r.error is None for r in rs)
    assert eng.host_syncs == eng.ticks + eng.admit_batches
    assert _drained(eng) and jeng.allocator.used == 0
    mine = [(r.out_tokens, r.out_ages) for r in rs]
    assert sum(len(t) for t, _ in mine) >= 8
    jf = jax.jit(lambda t, a: jax_forward(jp, jcfg, {"tokens": t,
                                                    "ages": a})["logits"])
    held = check_trajectories(
        [(t, a) for t, a, _ in reqs], mine, [u for _, _, u in reqs],
        lambda t, a: np.asarray(jf(jnp.asarray(t, jnp.int32),
                                   jnp.asarray(a))),
        margin_tol=2e-3, age_rtol=2e-3, max_age=cfg.max_age,
        death_token=cfg.death_token, max_context=W)
    assert held["steps"] == sum(len(t) for t, _ in mine)
    free = compare_runs([(r.out_tokens, r.out_ages) for r in jrs], mine,
                        age_rtol=0.25)
    assert free["compared"] >= len(reqs)
