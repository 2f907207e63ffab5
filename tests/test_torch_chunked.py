"""Chunked and suffix prefill in the port on the CPU, against the JAX
package and against the port's own straight-line oracle.

* ``ops.suffix_prefill_attention`` (its plain version on the CPU) against
  the JAX package's at ``tests/test_kernels.py``'s SUFFIX_CASES: valid rows
  within 2e-5 in fp32 (2e-2 with a bf16 cache); a padded chunk row, which
  has no valid key, is zeros in the port (the CUDA kernel's contract) where
  the JAX softmax spreads it evenly, so those rows are compared with 0.
* ``forward_suffix`` against the JAX package's on the same weights:
  measured on the CPU over four seeds, the logits agreed to < 7.2e-4 and
  the chunk's K/V to < 4.4e-3 (reduced and full-width Delphi-2M); the
  tests allow 2e-3 and 1e-2, as ``tests/test_torch_model.py`` does.
* Twins of ``tests/test_prefix.py``'s chunked-prefill tests: an unbounded
  chunk budget == the monolithic engine == ``chunked_reference_trajectory``
  bit for bit, the chunked engine == the oracle bit for bit, a partial
  hit prefills only its suffix, preemption re-acquires the prefix, a
  cancel mid-chunk leaks nothing, each future forked from a chunk-
  prefilled parent == the oracle (and == the unchunked fork where one
  chunk holds the prompt).  A multi-chunk prefill against the monolithic
  engine is held margin-aware instead of bit for bit: its softmax runs
  over other key widths (the JAX package's own bit-for-bit test of the
  one-block case fails, one age differing in its last digits).
* The port's chunked engine against the JAX package's chunked engine,
  margin-aware (teacher-forced with margin and age tolerance 2e-3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import init_delphi
from repro.kernels.ops import suffix_prefill_attention as jax_suffix
from repro.models import forward as jax_forward
from repro.models import forward_suffix as jax_forward_suffix
from repro.serve import BatchedEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.train import checkpoint as jax_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.parity import (check_trajectories, compare_runs,
                                     port_logits_fn)
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as launch
from repro_torch.models import (forward_suffix, init_params, load_checkpoint,
                                to_flat_numpy)
from repro_torch.serve import (BatchedEngine, Request, RequestCancelledError,
                               chunked_reference_trajectory)
from repro_torch.serve import engine as engine_mod

torch.set_num_threads(2)

W, BS, K = 64, 16, 4
TOKS = np.asarray([3, 10, 20, 30, 41], np.int32)
AGES = np.linspace(0.0, 30.0, 5).astype(np.float32)
LONG_TOKS = (np.arange(3, 24) % 90).astype(np.int32)     # S=21: full + tail
LONG_AGES = np.linspace(0.0, 30.0, 21).astype(np.float32)
LOGITS_ATOL = 2e-3
KV_ATOL = 1e-2


@functools.lru_cache(maxsize=None)
def _setup():
    """The reference tests' geometry: reduced Delphi, V 96, no age cap."""
    cfg = get_config("delphi-2m", reduced=True).replace(
        dtype="float32", vocab_size=96, max_seq_len=48, max_age=1e9)
    return init_params(cfg, seed=7, device="cpu"), cfg


def _engine(params, cfg, **kw):
    kw.setdefault("slots", K)
    kw.setdefault("max_context", W)
    kw.setdefault("cache", "paged")
    kw.setdefault("block_size", BS)
    return BatchedEngine(params, cfg, device="cpu", **kw)


def _uniforms(n, max_new, V, seed=42):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n, max_new, V)).astype(np.float32)


def _trajs(kids):
    return [(list(k.out_tokens), [np.float32(a) for a in k.out_ages])
            for k in kids]


def _one(eng, toks, ages, max_new, u):
    r = Request(tokens=toks, ages=ages, max_new=max_new, uniforms=u)
    eng.submit(r)
    eng.run()
    assert r.done and r.error is None
    assert eng.host_syncs == eng.ticks + eng.admit_batches
    return list(r.out_tokens), [np.float32(a) for a in r.out_ages]


def _oracle(params, cfg, toks, ages, u, max_new, **kw):
    kw.setdefault("slots", K)
    kw.setdefault("max_context", W)
    kw.setdefault("block_size", BS)
    t, a = chunked_reference_trajectory(params, cfg, toks, ages,
                                        max_new=max_new, uniforms=u,
                                        device="cpu", **kw)
    return t, [np.float32(x) for x in a]


def _drained(eng):
    return (eng.allocator.used == 0 and not eng.pool._refs
            and (eng._table == -1).all() and not eng._prefills)


def jax_params(flat):
    """The JAX model's nested parameter dict from the flat layout."""
    out = {}
    for key, arr in flat.items():
        node = out
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arr)
    return out


# ---------------------------------------------------------------------------
# suffix prefill attention against the JAX package
# ---------------------------------------------------------------------------
SUFFIX_CASES = [
    # (B, Sc, C, Hkv, G, hd, window, dtype): tests/test_kernels.py's cases
    (1, 16, 0, 1, 1, 32, None, "float32"),     # chunk at the prompt head
    (2, 16, 32, 2, 2, 32, None, "float32"),    # GQA mid-prompt chunk
    (1, 8, 24, 1, 4, 64, None, "float32"),     # strong GQA
    (2, 16, 16, 2, 1, 16, 12, "float32"),      # sliding window
    (1, 16, 32, 2, 2, 32, None, "bfloat16"),   # bf16 cache
]


def _suffix_inputs(B, Sc, C, Hkv, G, hd, seed=0):
    rng = np.random.default_rng(seed)
    Hq = Hkv * G
    arrs = [rng.standard_normal(s).astype(np.float32) for s in (
        (B, Sc, Hq, hd), (B, Sc, Hkv, hd), (B, Sc, Hkv, hd),
        (B, C, Hkv, hd), (B, C, Hkv, hd))]
    n_ctx = max(C - 3, 0)
    n_q = Sc - 2
    ctx_pos = np.full((B, C), -1, np.int32)
    ctx_pos[:, :n_ctx] = np.arange(n_ctx)
    q_pos = np.full((B, Sc), -1, np.int32)
    q_pos[:, :n_q] = n_ctx + np.arange(n_q)
    return arrs, q_pos, ctx_pos, n_q


@pytest.mark.parametrize("B,Sc,C,Hkv,G,hd,window,dtype", SUFFIX_CASES)
def test_suffix_prefill_attention_vs_jax(B, Sc, C, Hkv, G, hd, window,
                                         dtype):
    arrs, q_pos, ctx_pos, n_q = _suffix_inputs(B, Sc, C, Hkv, G, hd)
    jdt = getattr(jnp, dtype)
    theirs = jax_suffix(*(jnp.asarray(a).astype(jdt) for a in arrs),
                        jnp.asarray(q_pos), jnp.asarray(ctx_pos),
                        window=window, q_per_kv=G)
    tdt = getattr(torch, dtype)
    mine = ops.suffix_prefill_attention(
        *(torch.from_numpy(a).to(tdt) for a in arrs),
        torch.from_numpy(q_pos), torch.from_numpy(ctx_pos), window=window,
        q_per_kv=G)
    assert mine.shape == (B, Sc, Hkv * G, hd) and mine.dtype == tdt
    atol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(mine[:, :n_q].float().numpy(),
                               np.asarray(theirs[:, :n_q], np.float32),
                               atol=atol)
    assert not mine[:, n_q:].any(), "a row with no valid key must be zeros"


def test_head_chunk_equals_index_masked_flash_bit_for_bit():
    """A chunk at the prompt head with no context, by position, gives the
    index-masked prefill attention's bits on its valid rows: the basis of
    the unbounded-budget == monolithic invariant."""
    arrs, _, _, _ = _suffix_inputs(2, 16, 0, 2, 1, 10, seed=3)
    q, k, v, ck, cv = (torch.from_numpy(a) for a in arrs)
    n = 13
    pos = torch.full((2, 16), -1, dtype=torch.int32)
    pos[:, :n] = torch.arange(n, dtype=torch.int32)
    mine = ops.suffix_prefill_attention(q, k, v, ck, cv, pos,
                                        torch.zeros((2, 0), dtype=torch.int32))
    full = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2)).transpose(1, 2)
    assert torch.equal(mine[:, :n], full[:, :n])


def test_suffix_chunk_composes_with_full_prefill():
    """A mid-prompt chunk over its prefix as context equals the same rows of
    one causal pass over the whole prompt (2e-5)."""
    rng = np.random.default_rng(4)
    B, S, C, H, hd = 1, 48, 32, 2, 32
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, hd))
                                .astype(np.float32)) for _ in range(3))
    full = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2)).transpose(1, 2)
    pos = torch.arange(S, dtype=torch.int32)[None]
    out = ops.suffix_prefill_attention(q[:, C:], k[:, C:], v[:, C:],
                                       k[:, :C], v[:, :C], pos[:, C:],
                                       pos[:, :C])
    torch.testing.assert_close(out, full[:, C:], atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# forward_suffix against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [pytest.param(True, id="reduced"),
                                     pytest.param(False, id="delphi-2m")])
def test_forward_suffix_vs_jax(reduced):
    cfg = get_config("delphi-2m", reduced=reduced).replace(dtype="float32")
    jcfg = jax_config("delphi-2m", reduced=reduced).replace(dtype="float32")
    params = init_params(cfg, seed=1, device="cpu")
    jp = jax_params(to_flat_numpy(params))
    rng = np.random.default_rng(5)
    B, Sc, C = 2, 16, 32
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    toks = rng.integers(3, cfg.vocab_size, (B, Sc)).astype(np.int32)
    ages = np.sort(rng.uniform(30, 84, (B, Sc)), axis=1).astype(np.float32)
    ck, cv = (rng.standard_normal((L, B, C, Hkv, hd)).astype(np.float32)
              for _ in range(2))
    n_ctx, n = C - 3, Sc - 5
    cpos = np.full((B, C), -1, np.int32)
    cpos[:, :n_ctx] = np.arange(n_ctx)
    pos = np.full((B, Sc), -1, np.int32)
    pos[:, :n] = n_ctx + np.arange(n)
    li = np.full((B,), n - 1, np.int32)
    theirs = jax_forward_suffix(
        jp, jcfg, {"tokens": jnp.asarray(toks), "ages": jnp.asarray(ages),
                   "positions": jnp.asarray(pos)},
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv),
         "pos": jnp.asarray(cpos)}, last_index=jnp.asarray(li))
    mine = forward_suffix(
        params, cfg, {"tokens": torch.from_numpy(toks),
                      "ages": torch.from_numpy(ages),
                      "positions": torch.from_numpy(pos)},
        {"k": torch.from_numpy(ck), "v": torch.from_numpy(cv),
         "pos": torch.from_numpy(cpos)}, last_index=torch.from_numpy(li))
    assert mine["logits"].shape == (B, 1, cfg.vocab_size)
    assert mine["k"].shape == (L, B, Sc, Hkv, hd)
    np.testing.assert_allclose(mine["logits"].numpy(),
                               np.asarray(theirs["logits"]),
                               atol=LOGITS_ATOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(mine[key][:, :, :n].numpy(),
                                   np.asarray(theirs[key])[:, :, :n],
                                   atol=KV_ATOL)


def test_forward_suffix_refuses_recurrent_models():
    cfg = get_config("mamba2-780m", reduced=True).replace(dtype="float32")
    with pytest.raises(ValueError, match="attention-cache"):
        forward_suffix({}, cfg, {"tokens": torch.zeros((1, 16))}, {},
                       last_index=torch.zeros(1))


def test_chunk_helpers_are_the_jax_packages():
    """``_chunk_len`` and ``_chunk_arrays`` are copies: the same schedules
    and the same arrays."""
    from repro.serve import engine as jax_engine
    row = np.arange(1, 9, dtype=np.int32)
    for S, cur, budget, bs in [(21, 0, 16, 16), (21, 16, 16, 16),
                               (200, 64, 64, 16), (37, 8, 100, 8)]:
        n = engine_mod._chunk_len(S, cur, budget, bs)
        assert n == jax_engine._chunk_len(S, cur, budget, bs)
        toks = np.arange(S) % 90
        ages = np.linspace(0, 30, S)
        for a, b in zip(engine_mod._chunk_arrays(toks, ages, cur, n, bs, row),
                        jax_engine._chunk_arrays(toks, ages, cur, n, bs,
                                                 row)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the chunked engine (twins of tests/test_prefix.py's chunked tests)
# ---------------------------------------------------------------------------
def test_chunked_prefill_against_monolithic_and_the_oracle():
    """An unbounded budget reproduces the monolithic paged engine bit for
    bit, and both equal ``chunked_reference_trajectory`` at that budget
    (the engine == straight-line oracle gate of the paged engine).  The
    one-block engine equals the oracle at one block bit for bit, and is
    held against the monolithic run margin-aware: teacher-forced on the
    port's model (margin 1e-4, ages 1e-5 relative) and event for event up
    to any divergence (ages within ``core.parity``'s loose 0.25 relative:
    the age encoding amplifies a last-digit difference step by step)."""
    params, cfg = _setup()
    max_new = 6
    u = _uniforms(1, max_new, cfg.vocab_size, seed=23)[0]
    u[:, cfg.death_token] = 1e-12        # run all max_new events

    def run(**kw):
        eng = _engine(params, cfg, **kw)
        out = _one(eng, LONG_TOKS, LONG_AGES, max_new, u)
        assert _drained(eng)
        return out, eng

    base, _ = run()
    inf, eng_inf = run(prefill_chunk_tokens=W)
    chunked, eng16 = run(prefill_chunk_tokens=BS)
    assert inf == base, "unbounded chunk budget diverged from monolithic"
    assert base == _oracle(params, cfg, LONG_TOKS, LONG_AGES, u, max_new,
                           chunk_tokens=W)
    assert chunked == _oracle(params, cfg, LONG_TOKS, LONG_AGES, u, max_new,
                              chunk_tokens=BS)
    assert eng_inf.pool_stats()["prefill_chunks"] == 1
    st = eng16.pool_stats()
    assert st["prefill_chunk_tokens"] == BS
    assert st["chunked_prefills"] == 1 and st["prefill_chunks"] == 2
    assert st["suffix_tokens_saved"] == 0 and st["prefill_in_progress"] == 0
    # the 5-token tail chunk runs at the 8-wide monolithic bucket
    assert eng16.prefill_shapes == {("chunk", 0, 16), ("chunk", 1, 8)}
    held = check_trajectories(
        [(LONG_TOKS, LONG_AGES)], [chunked], [u],
        port_logits_fn(params, cfg), margin_tol=1e-4, age_rtol=1e-5,
        max_age=cfg.max_age, death_token=cfg.death_token, max_context=W)
    assert held["steps"] == max_new
    free = compare_runs([base], [chunked], age_rtol=0.25)
    assert free["compared"] >= 1


def test_partial_prefix_hit_prefills_only_suffix():
    """A partial index hit shares the matched blocks by reference and
    chunk-prefills only the unmatched suffix: ``suffix_tokens_saved``
    counts the skipped prefix, one chunk covers the 5-token tail, and the
    trajectory equals the matched-boundary oracle bit for bit."""
    params, cfg = _setup()
    max_new = 4
    eng = _engine(params, cfg, prefix_cache=True, prefill_chunk_tokens=BS)
    ua = _uniforms(1, max_new, cfg.vocab_size, seed=5)[0]
    ua[:, cfg.death_token] = 1e-12
    # registrant: a block-aligned prompt -> one full shareable block
    _one(eng, LONG_TOKS[:BS], LONG_AGES[:BS], max_new, ua)
    assert eng.prefix.entries >= 1
    chunks0 = eng.pool_stats()["prefill_chunks"]
    ub = _uniforms(1, max_new, cfg.vocab_size, seed=6)[0]
    ub[:, cfg.death_token] = 1e-12
    got = _one(eng, LONG_TOKS, LONG_AGES, max_new, ub)
    st = eng.pool_stats()
    assert st["suffix_tokens_saved"] == BS
    assert st["prefix_cache"]["partial_hits"] == 1
    assert st["prefill_chunks"] == chunks0 + 1      # suffix = one chunk
    assert got == _oracle(params, cfg, LONG_TOKS, LONG_AGES, ub, max_new,
                          chunk_tokens=BS, matched_tokens=BS)
    eng.drop_prefix_cache()
    assert _drained(eng)


def test_preempted_chunked_resume_reacquires_prefix():
    """Pool exhaustion preempts a forked future; its resume goes back
    through chunked admission, shares the indexed prefix by reference and
    re-prefills only the unmatched suffix.  The futures are held against
    the unchunked engine's through the same preemptions margin-aware, not
    bit for bit: a resume re-prefills its emitted events in several chunks,
    whose softmax runs over other key widths than the monolithic
    re-prefill's (the one-block case above).  Teacher-forced on the port's
    model (margin 1e-4, ages 1e-5 relative), and event for event up to any
    divergence (ages within 0.25 relative, as above)."""
    params, cfg = _setup()
    S = 16                               # exactly 2 full blocks at bs 8
    toks = (np.arange(3, 3 + S) % 90).astype(np.int32)
    ages = np.linspace(0.0, 30.0, S).astype(np.float32)
    u = _uniforms(3, 12, cfg.vocab_size, seed=7)
    u[:, :, cfg.death_token] = 1e-12
    kw = dict(slots=4, max_context=32, block_size=8, blocks=7,
              prefix_cache=True)
    eng = _engine(params, cfg, prefill_chunk_tokens=8, **kw)
    kids = eng.sample_futures(toks, ages, n=3, max_new=12, uniforms=u)
    assert all(k.done and k.error is None for k in kids)
    assert [len(k.out_tokens) for k in kids] == [12, 12, 12]
    assert eng.preemptions > 0
    st = eng.pool_stats()
    assert st["prefix_cache"]["partial_hits"] > 0, \
        "a resumed fork must share its prefix by reference"
    assert st["suffix_tokens_saved"] > 0, \
        "a resume must skip the matched prefix and prefill only the suffix"
    assert eng.host_syncs == eng.ticks + eng.admit_batches
    ref_eng = _engine(params, cfg, **kw)
    ref = _trajs(ref_eng.sample_futures(toks, ages, n=3, max_new=12,
                                        uniforms=u))
    mine = _trajs(kids)
    held = check_trajectories(
        [(toks, ages)] * 3, mine, list(u), port_logits_fn(params, cfg),
        margin_tol=1e-4, age_rtol=1e-5, max_age=cfg.max_age,
        death_token=cfg.death_token, max_context=32)
    assert held["steps"] == 36
    assert compare_runs(ref, mine, age_rtol=0.25)["compared"] >= 3
    eng.drop_prefix_cache()
    assert _drained(eng)


def test_cancel_mid_prefill_releases_partial_blocks():
    """Cancelling a slot whose prompt is still chunking releases its
    partly written blocks and its shared prefix references."""
    params, cfg = _setup()
    bs = 8
    eng = _engine(params, cfg, max_context=32, block_size=bs, blocks=8,
                  prefix_cache=True, prefill_chunk_tokens=bs)
    toks_a = (np.arange(3, 3 + bs) % 90).astype(np.int32)
    ages_a = np.linspace(0.0, 10.0, bs).astype(np.float32)
    ua = _uniforms(1, 2, cfg.vocab_size, seed=31)[0]
    ua[:, cfg.death_token] = 1e-12
    _one(eng, toks_a, ages_a, 2, ua)     # registers one shareable block
    assert eng.prefix.entries == 1
    toks_b = np.concatenate([toks_a,
                             np.arange(60, 76) % 90]).astype(np.int32)
    ages_b = np.concatenate([ages_a,
                             np.linspace(11.0, 30.0, 16)]).astype(np.float32)
    rb = Request(tokens=toks_b, ages=ages_b, max_new=4, request_id="mid")
    eng.submit(rb)
    eng.step()                           # admit + the first suffix chunk only
    st = eng.pool_stats()
    assert st["prefill_in_progress"] == 1
    assert st["suffix_tokens_saved"] == bs
    assert eng.cancel("mid")
    eng.run(max_ticks=50)
    assert rb.done and isinstance(rb.error, RequestCancelledError)
    assert eng.pool_stats()["prefill_in_progress"] == 0
    eng.drop_prefix_cache()
    assert _drained(eng)


@pytest.mark.parametrize("toks,ages", [
    pytest.param(TOKS, AGES, id="S=5"),
    pytest.param(LONG_TOKS, LONG_AGES, id="S=21")])
def test_fork_from_chunk_prefilled_parent(toks, ages):
    """A hold parent parks its bootstrap logits at the end of a chunked
    prefill as a monolithic admission does: each future of
    ``sample_futures`` through a chunked engine equals
    ``chunked_reference_trajectory`` on that future's uniforms bit for bit,
    and where the prompt fits one chunk (S=5) the futures equal the
    unchunked fork's bit for bit (a multi-chunk prefill is held to the
    oracle only: its softmax runs over other key widths)."""
    params, cfg = _setup()
    n, max_new = 3, 5
    u = _uniforms(n, max_new, cfg.vocab_size, seed=13)
    eng = _engine(params, cfg, prefill_chunk_tokens=BS)
    got = _trajs(eng.sample_futures(toks, ages, n=n, max_new=max_new,
                                    uniforms=u))
    assert got == [_oracle(params, cfg, toks, ages, u[j], max_new,
                           chunk_tokens=BS) for j in range(n)]
    if len(toks) <= BS:
        assert got == _trajs(_engine(params, cfg).sample_futures(
            toks, ages, n=n, max_new=max_new, uniforms=u))
    assert eng.pool_stats()["chunked_prefills"] == 1
    assert _drained(eng)


def test_fork_waits_for_a_parent_mid_prefill():
    """A fork queued while its parent's prompt is still chunking waits for
    the last chunk, then lands."""
    params, cfg = _setup()
    eng = _engine(params, cfg, prefill_chunk_tokens=BS)
    u = _uniforms(2, 3, cfg.vocab_size, seed=17)
    parent = Request(tokens=LONG_TOKS, ages=LONG_AGES, max_new=3, hold=True)
    eng.submit(parent)
    kids = eng.fork(parent.request_id, 2, uniforms=u)
    eng.step()                           # the first of two chunks
    assert eng.pool_stats()["prefill_in_progress"] == 1
    assert eng.forks == 0 and eng._fork_ops
    eng.run()
    assert eng.forks == 1
    assert all(k.done and k.error is None for k in kids)
    assert _drained(eng)


def test_long_prompt_chunks_between_ticks_of_short_requests():
    """Mixed traffic: a long prompt prefills a block a step while the short
    requests already admitted go on decoding, with no host copy for a
    chunk before the last; every request ends and the pool drains."""
    params, cfg = _setup()
    eng = _engine(params, cfg, max_context=W, prefill_chunk_tokens=BS)
    rng = np.random.default_rng(9)
    short = [Request(tokens=TOKS, ages=AGES, max_new=8,
                     uniforms=rng.random((8, cfg.vocab_size),
                                         dtype=np.float32))
             for _ in range(2)]
    for r in short:
        eng.submit(r)
    eng.step()
    long = Request(tokens=np.arange(3, 3 + 40) % 90,
                   ages=np.linspace(0, 60, 40).astype(np.float32),
                   max_new=4, uniforms=rng.random((4, cfg.vocab_size),
                                                  dtype=np.float32))
    eng.submit(long)
    ticks0, syncs0 = eng.ticks, eng.host_syncs
    eng.step()                           # first chunk beside a tick
    assert eng.pool_stats()["prefill_in_progress"] == 1
    assert eng.ticks == ticks0 + 1 and eng.host_syncs == syncs0 + 1
    eng.run()
    assert all(r.done and r.error is None for r in short + [long])
    # the short prompts in one chunk each, the long one in 16 + 16 + 8
    assert eng.prefill_chunks == 5 and eng.chunked_prefills == 3
    assert eng.host_syncs == eng.ticks + eng.admit_batches
    assert _drained(eng)


def test_chunked_knob_validation():
    params, cfg = _setup()
    with pytest.raises(ValueError, match="requires the paged KV cache"):
        BatchedEngine(params, cfg, cache="ring", prefill_chunk_tokens=16,
                      device="cpu")
    for bad in (BS + 1, 0):
        with pytest.raises(ValueError, match="positive multiple"):
            _engine(params, cfg, prefill_chunk_tokens=bad)
    with pytest.raises(ValueError, match="matched_tokens"):
        _oracle(params, cfg, TOKS, AGES,
                _uniforms(1, 2, cfg.vocab_size)[0], 2, chunk_tokens=BS,
                matched_tokens=3)


def test_serve_cli_prefill_chunk_tokens(capsys):
    out = launch.main(["--arch", "delphi-2m", "--requests", "3", "--slots",
                       "2", "--max-new", "4", "--cache", "paged",
                       "--prefill-chunk-tokens", "32", "--device", "cpu"])
    eng = out["engine"]
    assert len(out["done"]) == 3 and eng.prefill_chunk_tokens == 32
    assert eng.chunked_prefills == 3
    assert eng.host_syncs == eng.ticks + eng.admit_batches
    assert "served 3 requests" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        launch.parse_args(["--prefill-chunk-tokens", "32"])


# ---------------------------------------------------------------------------
# against the JAX package's chunked engine
# ---------------------------------------------------------------------------
def test_port_chunked_engine_vs_jax_chunked_engine(tmp_path):
    """One npz (the JAX package's checkpoint), the same prompts and
    uniforms, both engines chunked at one block with a prefix cache: the
    port's trajectories are held step by step against the JAX model on
    their own prefixes (margin and age tolerance 2e-3) and agree with JAX's
    event for event up to each one's first divergence (ages within 0.25
    relative, see ``core.parity``)."""
    jcfg = jax_config("delphi-2m", reduced=True).replace(dtype="float32")
    cfg = get_config("delphi-2m", reduced=True).replace(dtype="float32")
    jp = init_delphi(jcfg, jax.random.PRNGKey(6))
    jax_checkpoint.save(str(tmp_path), jp, jcfg)
    params = load_checkpoint(str(tmp_path), cfg, "cpu")
    rng = np.random.default_rng(11)
    max_new = 8
    prompts = []
    for S in (21, 40, 9, 33):
        prompts.append((rng.integers(3, cfg.vocab_size, S).astype(np.int32),
                        np.sort(rng.uniform(40, 70, S)).astype(np.float32)))
    prompts.append((prompts[1][0][:32], prompts[1][1][:32]))  # partial hit
    us = [rng.random((max_new, cfg.vocab_size), dtype=np.float32)
          for _ in prompts]
    kw = dict(slots=K, max_context=W, cache="paged", block_size=BS,
              prefix_cache=True, prefill_chunk_tokens=BS)
    jeng = JaxEngine(jp, jcfg, **kw)
    jreqs = [JaxRequest(tokens=t, ages=a, max_new=max_new, uniforms=u)
             for (t, a), u in zip(prompts, us)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    eng = BatchedEngine(params, cfg, device="cpu", **kw)
    reqs = [Request(tokens=t, ages=a, max_new=max_new, uniforms=u)
            for (t, a), u in zip(prompts, us)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done and r.error is None for r in reqs)
    assert eng.pool_stats()["prefill_chunks"] == \
        jeng.pool_stats()["prefill_chunks"]
    mine = [(r.out_tokens, r.out_ages) for r in reqs]
    jf = jax.jit(lambda t, a: jax_forward(jp, jcfg, {"tokens": t,
                                                    "ages": a})["logits"])
    held = check_trajectories(
        prompts, mine, us,
        lambda t, a: np.asarray(jf(jnp.asarray(t, jnp.int32),
                                   jnp.asarray(a))),
        margin_tol=2e-3, age_rtol=2e-3, max_age=cfg.max_age,
        death_token=cfg.death_token, max_context=W)
    assert held["steps"] == sum(len(t) for t, _ in mine)
    free = compare_runs([(r.out_tokens, r.out_ages) for r in jreqs], mine,
                        age_rtol=0.25)
    assert free["compared"] >= len(prompts)
