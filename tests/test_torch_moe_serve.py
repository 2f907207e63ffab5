"""The MoE LMs (OLMoE-1B-7B, Qwen2-MoE-A2.7B) on the port's serving,
training, checkpoint and SDK paths, on the CPU at reduced size, against
the JAX package's.

* The engine in generic-LM mode (Gumbel sampling, token-only requests)
  against JAX's ``BatchedEngine``: three requests on two slots, refilled
  past capacity; each of the port's token sequences is held step by step
  against the JAX model (margin 1e-4; the packages' logits agree within
  5.7e-6, ``tests/test_torch_moe.py``), and the free runs agree token for
  token up to each request's first divergence.  Within the port, ring ==
  paged == chunked == prefix-cached, and fork == ``ring_reference_futures``,
  bit for bit.
* One ``lm`` training step: ``loss`` (the CE plus ``router_aux_coef`` times
  the aux loss), ``event_ce`` and ``aux_loss`` within 1e-5 relative of
  ``jax.grad``'s step, every gradient (routers and experts included)
  within 1e-2 of its leaf's largest |g| (measured: the three values within
  2.2e-7 relative, gradients within 2.0e-6 of the leaf's largest).
* Checkpoints both ways: a JAX MoE checkpoint loads with every MoE field
  and is served through the server's ``--ckpt``, its logits within
  ``LM_ATOL`` 5e-5 of JAX's (measured 2.6e-6); the port's loads in JAX.
* The MoE artifact: the full, prefill and decode graphs equal the eager
  functions bit for bit (v2 decode == ``LocalBackend.stream``), the full
  graph's logits within ``LM_ATOL`` of JAX's ``get_logits`` (measured
  2.9e-6).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import get_logits as jax_get_logits
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.serve import BatchedEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.train import checkpoint as jax_ckpt
from repro.train.trainer import lm_loss as jax_lm_loss
from repro_torch.api import ArtifactBackend, Client, LocalBackend
from repro_torch.configs import get_config
from repro_torch.core.parity import check_lm_trajectories, compare_runs
from repro_torch.launch import serve as launch
from repro_torch.launch import train as launch_train
from repro_torch.models import forward, init_params, to_flat_numpy
from repro_torch.sdk import export_model, read_manifest
from repro_torch.serve import BatchedEngine, Request, server
from repro_torch.serve.prefix import ring_reference_futures
from repro_torch.train import checkpoint, loss_and_grads, make_loss_fn

torch.set_num_threads(2)

MOE_ARCHS = ["olmoe-1b-7b", "qwen2-moe-a2.7b"]
MOE_FIELDS = ("n_experts", "top_k", "n_shared_experts", "moe_d_ff",
              "router_aux_coef")
MAX_NEW = 6
LM_ATOL = 5e-5
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
def _setup(arch):
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
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_engine_vs_jax_engine_refills_past_capacity(arch):
    cfg, jcfg, params, jp = _setup(arch)
    reqs = [(np.arange(1, 7 + 3 * i, dtype=np.int32), u) for i, (_, u) in
            enumerate(_prompts(cfg, (1, 1, 1), seed=5, max_new=5))]
    jeng = JaxEngine(jp, jcfg, slots=2, max_context=48)
    jrs = [JaxRequest(tokens=t, max_new=5, uniforms=u) for t, u in reqs]
    for r in jrs:
        jeng.submit(r)
    jeng.run()
    eng, rs = _serve(params, cfg, reqs, slots=2, max_context=48, max_new=5)
    assert all(len(r.out_tokens) == 5 and r.out_ages == [] for r in rs)
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_ring_paged_chunked_prefix_fork_bit_identical(arch):
    """Bucketed right-padded prefill, the paged pool, 32-token chunked
    prefill, the prefix cache and hold/fork: the same tokens bit for
    bit."""
    cfg, _, params, _ = _setup(arch)
    reqs = _prompts(cfg, (5, 20, 33, 70, 90, 120), seed=1, max_new=10)
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_serves_a_moe_lm(arch, monkeypatch, capsys):
    """``--arch <moe>`` through the CLI at the reduced size: the weights
    made by the device route (fp32 on the CPU), random-id prompts,
    ``--max-context``, the paged cache."""
    real = launch.get_config
    monkeypatch.setattr(launch, "get_config",
                        lambda a: real(a, reduced=True))
    made = []
    real_init = launch.init_params_on_device
    monkeypatch.setattr(launch, "init_params_on_device",
                        lambda *a: made.append(a) or real_init(*a))
    out = launch.main(["--arch", arch, "--requests", "3", "--slots", "2",
                       "--max-new", "4", "--max-context", "160", "--cache",
                       "paged", "--device", "cpu"])
    eng = out["engine"]
    assert len(made) == 1 and eng.cfg.arch_type == "moe"
    assert len(out["done"]) == 3 and out["events"] == 12
    assert eng.max_context == 160 and not eng.is_delphi
    assert eng.host_syncs == eng.ticks + eng.admit_batches
    assert all(v.dtype == torch.float32 for v in eng.params.values())
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_train_step_vs_jax(arch):
    """``lm_loss``'s three values and one step's gradients against
    ``jax.grad`` (the reference's default ``dense_scan`` dispatch)."""
    cfg, jcfg, params, jp = _setup(arch)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 48))
             .astype(np.int32)}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads, m = loss_and_grads(make_loss_fn(cfg, "lm"), params, tb)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: (lambda mm: (mm["loss"], mm))(jax_lm_loss(p, jcfg, jb)),
        has_aux=True))(jp)
    for k in ("loss", "event_ce", "aux_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert float(m["aux_loss"]) > 0
    np.testing.assert_allclose(
        float(m["loss"]),
        float(m["event_ce"]) + cfg.router_aux_coef * float(m["aux_loss"]),
        rtol=1e-6)
    want = jax_flat(jg)
    assert set(grads) == set(want)
    assert any(k.startswith("layers/moe/") for k in grads)
    for k, g in grads.items():
        g = g.numpy()
        scale = float(np.abs(want[k]).max())
        assert scale > 0 and np.isfinite(g).all(), k
        err = float(np.abs(g - want[k]).max())
        assert err <= GRAD_REL * scale, (k, err, scale)


def test_train_cli_trains_olmoe_reduced(tmp_path):
    """``--arch olmoe-1b-7b --reduced`` trains on the CPU; its checkpoint
    keeps the MoE fields, and the JAX package reads it."""
    out = launch_train.main(["--arch", "olmoe-1b-7b", "--reduced", "--steps",
                             "3", "--batch", "2", "--seq-len", "32",
                             "--device", "cpu", "--out", str(tmp_path)])
    assert out["cfg"].arch_type == "moe"
    assert np.isfinite(out["history"]["loss"]).all()
    cfg, _ = checkpoint.load_config(str(tmp_path))
    jcfg, _ = jax_ckpt.load_config(str(tmp_path))
    want = get_config("olmoe-1b-7b", reduced=True)
    for f in MOE_FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f) == getattr(want, f), f


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_checkpoints_both_ways_keep_the_moe_fields(arch, tmp_path):
    """A JAX MoE checkpoint: ``load_config`` keeps ``n_experts``,
    ``top_k``, ``n_shared_experts``, ``moe_d_ff`` and ``router_aux_coef``
    (changed from the config's own so that a dropped field would show),
    the server's ``--ckpt`` serves it with logits within ``LM_ATOL`` of
    JAX's, and the port's checkpoint of the same weights loads in JAX."""
    jcfg = jax_config(arch, reduced=True).replace(
        dtype="float32", n_experts=6, top_k=3, moe_d_ff=96,
        router_aux_coef=0.02)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(4))
    jax_ckpt.save(str(tmp_path / "jax"), jp, jcfg)
    cfg, _ = checkpoint.load_config(str(tmp_path / "jax"))
    for f in MOE_FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.arch_type == "moe"
    backend = server._build_backend(server.parse_args(
        ["--config", arch, "--reduced", "--ckpt", str(tmp_path / "jax"),
         "--device", "cpu", "--backend", "local"]))
    assert isinstance(backend, LocalBackend)
    assert backend.cfg.n_experts == 6 and backend.cfg.dtype == "float32"
    toks = [3, 17, 250, 9, 100]
    t = np.zeros((1, backend.seq_len), np.int32)
    t[0, :5] = toks
    want = np.asarray(jax_forward(jp, jcfg, {"tokens": jnp.asarray(t)},
                                  mode="train")["logits"])[0, 4]
    np.testing.assert_allclose(backend.logits(toks), want, atol=LM_ATOL,
                               rtol=0)
    checkpoint.save(str(tmp_path / "port"), backend.params, cfg)
    jcfg2, _ = jax_ckpt.load_config(str(tmp_path / "port"))
    for f in MOE_FIELDS:
        assert getattr(jcfg2, f) == getattr(jcfg, f), f
    jback = jax_flat(jax_ckpt.restore(
        str(tmp_path / "port"), jax_init_params(jcfg2,
                                                jax.random.PRNGKey(0))))
    assert set(jback) == set(backend.params)
    assert all((jback[k] == backend.params[k].numpy()).all()
               for k in jback)


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_artifact_equals_eager_and_jax(arch, tmp_path):
    """The all-expert route traces (no data-dependent shape): v2 decode
    gives the full graph's tokens, the decode graph takes ``(token,
    step)``, the full graph's logits equal eager ``forward`` bit for bit
    and JAX's ``get_logits`` within ``LM_ATOL``, and the artifact's
    prefill + decode stream equals ``LocalBackend.stream`` token for
    token."""
    cfg, jcfg, params, jp = _setup(arch)
    d = str(tmp_path / "moe_art")
    export_model(params, cfg, d, seq_len=64)
    m = read_manifest(d)
    assert [i["name"] for i in m["graphs"]["decode_step"]["inputs"]] == [
        "cache", "token", "step"]
    u = np.random.default_rng(11).uniform(
        size=(6, cfg.vocab_size)).astype(np.float32)
    toks = [1, 5, 9, 200]
    full = Client(ArtifactBackend(d, use_decode_graph=False, device="cpu"))
    dec = Client(ArtifactBackend(d, device="cpu"))
    local = Client(LocalBackend(params, cfg, seq_len=64, device="cpu"))
    a = full.generate(tokens=toks, max_new=6, uniforms=u)
    b = dec.generate(tokens=toks, max_new=6, uniforms=u)
    assert len(b.tokens) == 6 and b.tokens == a.tokens
    assert [e.token for e in local.stream(tokens=toks, max_new=6,
                                          uniforms=u)] == b.tokens
    t = np.zeros((1, 64), np.int32)
    t[0, :4] = toks
    with torch.no_grad():
        eager = forward(params, cfg, {"tokens": torch.from_numpy(t)},
                        mode="train")["logits"][0, 3].numpy()
    assert (full.backend.logits(toks) == eager).all()
    assert (local.backend.logits(toks) == eager).all()
    want = np.asarray(jax_get_logits(jp, jcfg, jnp.asarray(t),
                                     jnp.zeros((1, 64), jnp.float32)))[0, 3]
    np.testing.assert_allclose(full.backend.logits(toks), want, atol=LM_ATOL,
                               rtol=0)
