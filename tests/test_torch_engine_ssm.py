"""The port's ``BatchedEngine`` in generic-LM mode (Gumbel sampling) on
reduced Mamba2, on the CPU, against the JAX package's ``BatchedEngine``.

Both engines serve the same numpy-seeded prompts with the same injected
uniforms.  Each of the port's token sequences is held step by step against
the JAX model on its own prefix (teacher forcing, margin-aware on the
Gumbel scores ``logits / temperature + g(u)``, ROADMAP rule 5) with a
margin of 1e-4 (the two packages' logits agree to < 4.2e-6 on this
configuration, ``tests/test_torch_ssm.py``), and the two engines' free runs
must agree token for token up to each request's first divergence.  A
recurrent model admits each prompt solo at its exact length, so every
prefill shape is ``(1, S)``, as in the JAX engine.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import forward as jax_forward
from repro.serve import BatchedEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.core.parity import check_lm_trajectories, compare_runs
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch
from repro_torch.models import init_params, to_flat_numpy
from repro_torch.serve import BatchedEngine, Request
from repro_torch.serve import engine as engine_mod

torch.set_num_threads(2)

MAX_NEW, W = 6, 256


def jax_params(flat):
    out = {}
    for key, arr in flat.items():
        node = out
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arr)
    return out


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = get_config("mamba2-780m", reduced=True).replace(dtype="float32")
    jcfg = jax_config("mamba2-780m", reduced=True).replace(dtype="float32")
    params = init_params(cfg, seed=2, device="cpu")
    return cfg, jcfg, params, jax_params(to_flat_numpy(params))


def _requests(cfg, n, seed=0):
    """Prompts of 2-99 tokens (one to four chunks of 32), with uniforms."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        S = int(rng.integers(2, 100))
        toks = rng.integers(0, cfg.vocab_size, S).astype(np.int32)
        u = rng.random((MAX_NEW, cfg.vocab_size), dtype=np.float32)
        out.append((toks, u))
    return out


def _serve_port(params, cfg, reqs, *, slots=2, **kw):
    eng = BatchedEngine(params, cfg, slots=slots, max_context=W,
                        device="cpu", **kw)
    rs = [Request(tokens=t, max_new=MAX_NEW, uniforms=u) for t, u in reqs]
    for r in rs:
        eng.submit(r)
    eng.run()
    return eng, rs


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_lm_engine_vs_jax_engine(temperature):
    cfg, jcfg, params, jp = _setup()
    reqs = _requests(cfg, 5)
    jeng = JaxEngine(jp, jcfg, slots=2, max_context=W,
                     temperature=temperature)
    jrs = [JaxRequest(tokens=t, max_new=MAX_NEW, uniforms=u) for t, u in reqs]
    for r in jrs:
        jeng.submit(r)
    jeng.run()
    eng, rs = _serve_port(params, cfg, reqs, temperature=temperature)
    assert all(r.done and r.error is None for r in rs)
    assert all(len(r.out_tokens) == MAX_NEW and r.out_ages == [] for r in rs)
    assert eng.host_syncs == eng.ticks + eng.admit_batches
    assert eng.admit_batches == len(reqs)           # solo admissions
    assert eng.prefill_shapes == {(1, len(t)) for t, _ in reqs}
    assert eng.prefill_shapes == jeng.prefill_shapes

    jf = jax.jit(lambda t: jax_forward(jp, jcfg, {"tokens": t})["logits"])
    held = check_lm_trajectories(
        [t for t, _ in reqs], [r.out_tokens for r in rs], [u for _, u in reqs],
        lambda t, a: np.asarray(jf(jnp.asarray(t, jnp.int32))),
        margin_tol=1e-4, inv_temp=1.0 / temperature)
    assert held["steps"] == len(reqs) * MAX_NEW
    free = compare_runs([(r.out_tokens, []) for r in jrs],
                        [(r.out_tokens, []) for r in rs], age_rtol=0.0)
    assert free["compared"] >= len(reqs)    # at least every first token


def test_lm_engine_refills_past_slot_capacity():
    """Three requests on two slots, generator-sampled: the third admits
    when a slot frees, and every request gets its full budget."""
    cfg, _, params, _ = _setup()
    eng = BatchedEngine(params, cfg, slots=2, max_context=48, device="cpu")
    rs = [Request(tokens=np.arange(1, 7 + i, dtype=np.int32), max_new=5)
          for i in range(3)]
    for r in rs:
        eng.submit(r)
    done = eng.run()
    assert len(done) == 3
    for r in done:
        assert len(r.out_tokens) == 5 and r.out_ages == []
        assert all(0 <= t < cfg.vocab_size for t in r.out_tokens)
    assert eng.host_syncs == eng.ticks + eng.admit_batches
    assert eng.prefill_shapes == {(1, 6), (1, 7), (1, 8)}


def test_lm_engine_runs_are_bit_identical_and_sync_once_per_tick(
        monkeypatch):
    cfg, _, params, _ = _setup()
    reqs = _requests(cfg, 4, seed=1)
    copies = []
    real = engine_mod._to_host
    monkeypatch.setattr(engine_mod, "_to_host",
                        lambda x: copies.append(x.shape) or real(x))

    def no_sync(*a, **k):
        raise AssertionError("a device value was read on the host")
    for name in ("item", "tolist", "__bool__", "__float__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, no_sync)
    eng1, rs1 = _serve_port(params, cfg, reqs, slots=3)
    eng2, rs2 = _serve_port(params, cfg, reqs, slots=3)
    monkeypatch.undo()
    assert [r.out_tokens for r in rs1] == [r.out_tokens for r in rs2]
    for eng in (eng1, eng2):
        assert eng.host_syncs == eng.ticks + eng.admit_batches
    assert len(copies) == eng1.host_syncs + eng2.host_syncs
    assert all(s[0] == 4 for s in copies)       # (4, slots) packed rows


def test_lm_generator_sampled_runs_are_reproducible():
    cfg, _, params, _ = _setup()
    outs = []
    for _ in range(2):
        eng = BatchedEngine(params, cfg, slots=3, max_context=W, seed=11,
                            device="cpu")
        rs = [Request(tokens=t, max_new=MAX_NEW)
              for t, _ in _requests(cfg, 4, seed=2)]
        for r in rs:
            eng.submit(r)
        eng.run()
        assert all(r.done and len(r.out_tokens) == MAX_NEW for r in rs)
        outs.append([r.out_tokens for r in rs])
    assert outs[0] == outs[1]


def test_lm_engine_runs_the_ssd_path_once_per_layer_and_admission():
    """On the CPU the wrapper takes the plain version and counts nothing;
    the model calls ``ssd_intra`` once per layer per admission (the card's
    launch count, which chip_smoke.py asserts)."""
    cfg, _, params, _ = _setup()
    calls = []
    real = ops.ssd_intra_heads
    ops.reset_launch_counts()
    try:
        ops.ssd_intra_heads = lambda *a: calls.append(1) or real(*a)
        eng, _ = _serve_port(params, cfg, _requests(cfg, 3, seed=4))
    finally:
        ops.ssd_intra_heads = real
    assert len(calls) == cfg.n_layers * eng.admit_batches
    assert ops.launch_counts()["ssd_intra"] == 0


def test_serve_cli_serves_mamba2_on_cpu(monkeypatch, capsys):
    """``--arch mamba2-780m`` through the CLI, cut to the reduced config
    with a vocabulary that holds the synthetic prompts' event ids (the full
    780M model is the card's job)."""
    real = launch.get_config
    monkeypatch.setattr(launch, "get_config", lambda arch: real(
        arch, reduced=True).replace(vocab_size=2048))
    out = launch.main(["--arch", "mamba2-780m", "--requests", "3", "--slots",
                       "2", "--max-new", "4", "--device", "cpu"])
    eng = out["engine"]
    assert len(out["done"]) == 3 and out["events"] == 12
    assert eng.max_context == eng.cfg.max_seq_len
    assert eng.host_syncs == eng.ticks + eng.admit_batches
    assert all(nb == 1 for nb, _ in eng.prefill_shapes)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
