"""The generic dense LMs and Delphi-100M on the port's serving, training
and SDK paths, on the CPU at reduced size, against the JAX package's.

* The engine in generic-LM mode (RoPE, Gumbel sampling, token-only
  requests) on reduced TinyLlama against JAX's ``BatchedEngine`` (its
  ``tests/test_serve_device.py::test_lm_mode_device_engine``: three
  requests on two slots, refilled past capacity): each of the port's token
  sequences is held step by step against the JAX model (margin 1e-4; the
  packages' logits agree within 6.9e-6 here, ``tests/test_torch_dense.py``),
  and the free runs agree token for token up to each request's first
  divergence.  Within the port, ring == paged == chunked == prefix-cached,
  and fork == ``ring_reference_futures``, bit for bit, on reduced TinyLlama
  and on reduced H2O-Danube with prompts longer than its window of 64.
* One ``lm`` training step on reduced TinyLlama and one Delphi step on
  reduced Delphi-100M at S 1024 (``max_seq_len`` 1024: the blocked
  attention route): loss within 1e-5 relative, every gradient within 1e-2
  of its leaf's largest |g| (measured: TinyLlama loss 7.2e-8 relative and
  gradients 1.9e-6; Delphi-100M 1.9e-6 and 2.1e-3, the age-encoding ulp);
  the Delphi head on the TinyLlama backbone
  (``test_paper_technique_attaches_to_zoo_backbone``): the dual loss and
  its gradients against JAX's, the same allowances (measured 1.1e-7 and
  1.3e-6), and generated ages that never fall.
* The generic-LM artifact (``tests/test_api.py::
  test_v2_decode_matches_full_graph_generic_lm``): reduced TinyLlama, fp32;
  v2 decode gives the full graph's tokens; the decode graph takes
  ``(token, step)``; the full graph's logits against JAX's within 5e-5
  (measured 2.5e-6).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.delphi import loss_fn as jax_delphi_loss
from repro.models import forward as jax_forward
from repro.serve import BatchedEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.train.trainer import lm_loss as jax_lm_loss
from repro_torch.api import ArtifactBackend, Client, LocalBackend
from repro_torch.configs import get_config
from repro_torch.core import generate_trajectories
from repro_torch.core.parity import check_lm_trajectories, compare_runs
from repro_torch.data import (SimulatorConfig, generate_dataset,
                              pack_trajectories)
from repro_torch.launch import serve as launch
from repro_torch.launch import train as launch_train
from repro_torch.models import forward, init_params, to_flat_numpy
from repro_torch.sdk import export_model, read_manifest
from repro_torch.serve import BatchedEngine, Request
from repro_torch.serve.prefix import ring_reference_futures
from repro_torch.train import checkpoint, loss_and_grads, make_loss_fn

torch.set_num_threads(2)

MAX_NEW = 6
LOSS_RTOL = 1e-5
GRAD_REL = 1e-2


def jax_params(flat):
    out = {}
    for key, arr in flat.items():
        node = out
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arr)
    return out


def jax_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(jax_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _setup(arch="tinyllama-1.1b"):
    cfg = get_config(arch, reduced=True).replace(dtype="float32")
    jcfg = jax_config(arch, reduced=True).replace(dtype="float32")
    params = init_params(cfg, seed=2, device="cpu")
    return cfg, jcfg, params, jax_params(to_flat_numpy(params))


def _prompts(cfg, lens, seed=0, max_new=MAX_NEW):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, S).astype(np.int32),
             rng.random((max_new, cfg.vocab_size), dtype=np.float32))
            for S in lens]


def _serve(params, cfg, reqs, *, slots, max_context, max_new=MAX_NEW, **kw):
    eng = BatchedEngine(params, cfg, slots=slots, max_context=max_context,
                        device="cpu", **kw)
    rs = [Request(tokens=t, max_new=max_new, uniforms=u) for t, u in reqs]
    for r in rs:
        eng.submit(r)
    eng.run()
    assert all(r.done and r.error is None for r in rs)
    assert eng.host_syncs == eng.ticks + eng.admit_batches
    return eng, rs


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def test_lm_engine_vs_jax_engine_refills_past_capacity():
    cfg, jcfg, params, jp = _setup()
    reqs = [(np.arange(1, 7 + i, dtype=np.int32), u) for i, (_, u) in
            enumerate(_prompts(cfg, (1, 1, 1), seed=5, max_new=5))]
    jeng = JaxEngine(jp, jcfg, slots=2, max_context=48)
    jrs = [JaxRequest(tokens=t, max_new=5, uniforms=u) for t, u in reqs]
    for r in jrs:
        jeng.submit(r)
    jeng.run()
    eng, rs = _serve(params, cfg, reqs, slots=2, max_context=48, max_new=5)
    assert all(len(r.out_tokens) == 5 and r.out_ages == [] for r in rs)
    assert all(0 <= t < cfg.vocab_size for r in rs for t in r.out_tokens)
    assert eng.admit_batches >= 2                   # refilled a slot
    jf = jax.jit(lambda t: jax_forward(jp, jcfg, {"tokens": t})["logits"])
    held = check_lm_trajectories(
        [t for t, _ in reqs], [r.out_tokens for r in rs], [u for _, u in reqs],
        lambda t, a: np.asarray(jf(jnp.asarray(t, jnp.int32))),
        margin_tol=1e-4)
    assert held["steps"] == 15
    free = compare_runs([(r.out_tokens, []) for r in jrs],
                        [(r.out_tokens, []) for r in rs], age_rtol=0.0)
    assert free["compared"] >= len(reqs)


@pytest.mark.parametrize("arch,lens", [
    ("tinyllama-1.1b", (5, 20, 33, 70, 90, 120)),
    ("h2o-danube-1.8b", (70, 90, 120, 5, 130, 100))])
def test_ring_paged_chunked_prefix_fork_bit_identical(arch, lens):
    """Bucketed right-padded prefill, the paged pool, 32-token chunked
    prefill, the prefix cache and hold/fork: the same tokens bit for bit
    (Danube's prompts pass its window of 64, and decode runs on past it
    with ``max_context`` 256 > the window)."""
    cfg, _, params, _ = _setup(arch)
    reqs = _prompts(cfg, lens, seed=1, max_new=10)
    runs = {}
    for name, kw in (("ring", {}), ("paged", dict(cache="paged")),
                     ("chunked", dict(cache="paged",
                                      prefill_chunk_tokens=32)),
                     ("prefix", dict(cache="paged", prefix_cache=True))):
        eng, rs = _serve(params, cfg, reqs, slots=3, max_context=256,
                         max_new=10, **kw)
        runs[name] = [r.out_tokens for r in rs]
        if eng.paged:
            eng.drop_prefix_cache()
            assert eng.allocator.used == 0 and not eng.pool._refs
    assert all(len(t) == 10 for t in runs["ring"])
    for name in ("paged", "chunked", "prefix"):
        assert runs[name] == runs["ring"], name
    toks, _ = reqs[2]
    us = np.random.default_rng(8).random((4, 8, cfg.vocab_size),
                                         dtype=np.float32)
    want = ring_reference_futures(params, cfg, toks, n=4, max_new=8,
                                  uniforms=us, max_context=256, device="cpu")
    for kw in ({}, dict(cache="paged", prefix_cache=True)):
        eng = BatchedEngine(params, cfg, slots=3, max_context=256,
                            device="cpu", **kw)
        kids = eng.sample_futures(toks, n=4, max_new=8, uniforms=us)
        assert [(k.out_tokens, k.out_ages) for k in kids] == \
            [(t, list(a)) for t, a in want]


def test_serve_cli_serves_a_generic_dense_lm(monkeypatch, capsys):
    """``--arch tinyllama-1.1b`` through the CLI at the reduced size:
    seeded random-id prompts, ``--max-context``, the paged cache."""
    real = launch.get_config
    monkeypatch.setattr(launch, "get_config",
                        lambda arch: real(arch, reduced=True))
    out = launch.main(["--arch", "tinyllama-1.1b", "--requests", "3",
                       "--slots", "2", "--max-new", "4", "--max-context",
                       "160", "--cache", "paged", "--device", "cpu"])
    eng = out["engine"]
    assert len(out["done"]) == 3 and out["events"] == 12
    assert eng.max_context == 160 and not eng.is_delphi
    assert eng.host_syncs == eng.ticks + eng.admit_batches
    lens = [len(p) for p in launch.lm_prompts(3, 512, 0)]
    assert all(16 <= n <= 128 for n in lens)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _check_grads(grads, want):
    assert set(grads) == set(want)
    for k, g in grads.items():
        g = g.numpy()
        scale = float(np.abs(want[k]).max())
        assert scale > 0 and np.isfinite(g).all(), k
        err = float(np.abs(g - want[k]).max())
        assert err <= GRAD_REL * scale, (k, err, scale)


def _vs_jax(cfg, jcfg, params, batch, objective):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads, m = loss_and_grads(make_loss_fn(cfg, objective), params, tb)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jfn = jax_lm_loss if objective == "lm" else jax_delphi_loss
    (_, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: (lambda mm: (mm["loss"], mm))(jfn(p, jcfg, jb)),
        has_aux=True))(jax_params(to_flat_numpy(params)))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    _check_grads(grads, jax_flat(jg))
    return m


def test_lm_train_step_vs_jax_tinyllama():
    cfg, jcfg, params, _ = _setup()
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 48))
             .astype(np.int32)}
    _vs_jax(cfg, jcfg, params, batch, "lm")


def test_delphi_100m_train_step_at_1024_vs_jax():
    """Reduced Delphi-100M with its full ``max_seq_len`` of 1024, a batch
    of 2 x 1024 (the blocked attention route): loss and gradients."""
    kw = dict(dtype="float32", vocab_size=1289, max_seq_len=1024)
    cfg = get_config("delphi-100m", reduced=True).replace(**kw)
    jcfg = jax_config("delphi-100m", reduced=True).replace(**kw)
    params = init_params(cfg, seed=4, device="cpu")
    train, _ = generate_dataset(SimulatorConfig(n_train=40, n_val=1, seed=3))
    packed = pack_trajectories(train, 1024)
    batch = {k: v[:2] for k, v in packed.items()}
    assert batch["tokens"].shape == (2, 1024)
    _vs_jax(cfg, jcfg, params, batch, "delphi")


def test_delphi_head_on_tinyllama_backbone_vs_jax():
    """JAX's ``test_paper_technique_attaches_to_zoo_backbone``: the dual
    head (``out_bias``) on the RoPE/GQA backbone, the dual loss against
    JAX's, then eq.-1 trajectories whose ages never fall."""
    cfg = get_config("tinyllama-1.1b", reduced=True).replace(
        dtype="float32", dual_head=True)
    jcfg = jax_config("tinyllama-1.1b", reduced=True).replace(
        dtype="float32", dual_head=True)
    params = init_params(cfg, seed=6, device="cpu")
    assert "embed/out_bias" in params
    train, _ = generate_dataset(SimulatorConfig(n_train=8, n_val=1, seed=2))
    packed = pack_trajectories(train, 16)
    batch = {k: v[:2] for k, v in packed.items()}
    batch["tokens"] = batch["tokens"] % cfg.vocab_size
    batch["targets"] = batch["targets"] % cfg.vocab_size
    m = _vs_jax(cfg, jcfg, params, batch, "delphi")
    assert float(m["time_nll"]) > 0
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        out = generate_trajectories(
            params, cfg, torch.from_numpy(batch["tokens"][:, :8]),
            torch.from_numpy(batch["ages"][:, :8]), max_new=6,
            generator=gen)
    assert float(out["ages"].diff(dim=1).min()) >= -1e-5


def test_train_cli_trains_a_generic_lm_and_keeps_rope_theta(
        monkeypatch, tmp_path):
    real = launch_train.get_config
    monkeypatch.setattr(launch_train, "get_config", lambda arch, reduced:
                        real(arch, reduced=True))
    out = launch_train.main(["--arch", "qwen2.5-32b", "--steps", "3",
                             "--batch", "2", "--seq-len", "32",
                             "--device", "cpu", "--out", str(tmp_path)])
    assert np.isfinite(out["history"]["loss"]).all()
    cfg, _ = checkpoint.load_config(str(tmp_path))
    assert cfg.rope_theta == 1e6 and cfg.qkv_bias
    assert out["target_tokens"] == 3 * 2 * 31


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------
def test_v2_decode_matches_full_graph_generic_lm(tmp_path):
    cfg, jcfg, params, jp = _setup()
    d = str(tmp_path / "lm_art")
    export_model(params, cfg, d, seq_len=64)
    m = read_manifest(d)
    assert [i["name"] for i in m["graphs"]["decode_step"]["inputs"]] == [
        "cache", "token", "step"]
    u = np.random.default_rng(11).uniform(
        size=(4, cfg.vocab_size)).astype(np.float32)
    toks = [1, 5, 9]
    full = Client(ArtifactBackend(d, use_decode_graph=False, device="cpu"))
    dec = Client(ArtifactBackend(d, device="cpu"))
    a = full.generate(tokens=toks, max_new=4, uniforms=u)
    b = dec.generate(tokens=toks, max_new=4, uniforms=u)
    assert len(b.tokens) == 4 and b.tokens == a.tokens
    local = Client(LocalBackend(params, cfg, seq_len=64, device="cpu"))
    assert [e.token for e in local.stream(tokens=toks, max_new=4,
                                          uniforms=u)] == b.tokens
    t = np.zeros((1, 64), np.int32)
    t[0, :3] = toks
    want = np.asarray(jax_forward(jp, jcfg, {"tokens": jnp.asarray(t)},
                                  mode="train")["logits"])[0, 2]
    np.testing.assert_allclose(full.backend.logits(toks), want, atol=5e-5,
                               rtol=0)
