"""Zamba2 (Mamba2 layers with one weight-shared attention block) on the
port against the JAX package, in fp32 on the CPU.

Two variants of reduced ``zamba2-1.2b``: the JAX package's own reduced
config (2 layers, the shared block before each: ``attn_every`` 1, 2
applications) and a periodic one (5 layers, ``attn_every`` 2: applications
before layers 0, 2 and 4).  Weights: the port's numpy-seeded
``init_params``, handed to the JAX model through the flat checkpoint
layout.  The same numpy-seeded tokens go through both packages:

* train-mode logits (the kernel route and the differentiable route);
* a 70-token prefill, past the reduced window of 64 so that each
  application's ring wraps, then 8 ``decode_step``s, against JAX's
  ``forward(mode="prefill")`` and ``decode_step`` (and the ring positions);
* one training step's ``lm_loss`` and the gradient of every parameter,
  ``shared_attn/*`` included (summed over the applications, as
  ``jax.grad`` sums them), against ``jax.value_and_grad``;
* the engine: a straight-line oracle (``ring_reference_futures``, one
  future a request) bit for bit; a held parent, forked after other
  traffic has ticked, equal to immediate forks bit for bit; the fork copy
  masking ring positions past the prompt in every application's ring; the
  paged cache refused; tokens against the JAX engine's, margin-aware;
* the serve and train CLIs, and checkpoints both ways.

Tolerances, measured on these inputs (CPU, fp32): logits and the final
Mamba state within 1.5e-5 of JAX's (train, prefill and decode; allowed
1e-4, the Mamba2 tests'), the loss within 7.1e-8 relative (allowed 1e-5),
the gradients within 9.9e-6 of each leaf's largest |g| (allowed 1e-4
relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.serve import BatchedEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.train import checkpoint as jax_ckpt
from repro.train.trainer import lm_loss as jax_lm_loss
from repro_torch.configs import get_config
from repro_torch.core.parity import check_lm_trajectories, compare_runs
from repro_torch.launch import serve as launch
from repro_torch.launch import train as launch_train
from repro_torch.models import (LayerCache, decode_step, forward,
                                from_jax_flat, init_params,
                                make_decode_cache, n_attn_apps,
                                to_flat_numpy)
from repro_torch.models.params import param_shapes
from repro_torch.serve import BatchedEngine, Request
from repro_torch.serve.engine import _fork_copy_rows
from repro_torch.serve.prefix import ring_reference_futures
from repro_torch.train import checkpoint, loss_and_grads, make_loss_fn

torch.set_num_threads(2)

LOGITS_ATOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
VARIANTS = {"reduced": {}, "periodic": dict(n_layers=5, attn_every=2)}
CTX = 128          # the engine's max_context: its rings are the window's 64


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


def _setup(variant="reduced", seed=0):
    kw = dict(dtype="float32", **VARIANTS[variant])
    cfg = get_config("zamba2-1.2b", reduced=True).replace(**kw)
    jcfg = jax_config("zamba2-1.2b", reduced=True).replace(**kw)
    params = init_params(cfg, seed=seed, device="cpu")
    return cfg, jcfg, params, jax_params(to_flat_numpy(params))


def _tokens(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


def _np(x):
    return np.asarray(x, dtype=np.float32)


# ---------------------------------------------------------------------------
# config and weights
# ---------------------------------------------------------------------------
def test_config_and_bridge_match_jax():
    """The full config's shapes (38 layers, 7 applications) equal JAX's
    ``init_params`` pytree's; a reduced JAX init round-trips exactly in
    fp32 (``from_jax_flat`` stores each leaf in its use dtype, all fp32
    under an fp32 config)."""
    cfg = get_config("zamba2-1.2b")
    assert (cfg.arch_type, cfg.n_layers, cfg.attn_every) == ("hybrid", 38, 6)
    assert n_attn_apps(cfg) == 7 and cfg.ssm_n_heads == 64
    jcfg = jax_config("zamba2-1.2b")
    shapes = jax.eval_shape(lambda: jax_init_params(
        jcfg, jax.random.PRNGKey(0)))
    want = {"/".join(k.key for k in path): tuple(v.shape) for path, v in
            jax.tree_util.tree_leaves_with_path(shapes)}
    assert param_shapes(cfg) == want
    red = jax_config("zamba2-1.2b", reduced=True).replace(dtype="float32")
    flat = jax_flat(jax_init_params(red, jax.random.PRNGKey(1)))
    back = to_flat_numpy(from_jax_flat(
        flat, get_config("zamba2-1.2b", reduced=True).replace(
            dtype="float32"), device="cpu"))
    assert set(back) == set(flat)
    assert all((back[k] == flat[k]).all() for k in flat)


# ---------------------------------------------------------------------------
# the model against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_logits_vs_jax(variant):
    cfg, jcfg, params, jp = _setup(variant)
    toks = _tokens(cfg, (2, 100), seed=1)
    want = _np(jax_forward(jp, jcfg, {"tokens": jnp.asarray(toks)})["logits"])
    batch = {"tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        got = forward(params, cfg, batch)["logits"].numpy()
        plain = forward(params, cfg, batch,
                        differentiable=True)["logits"].numpy()
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(plain, want, atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_then_decode_vs_jax(variant):
    """A 70-token prompt (each ring of the window's 64 wraps), then 8 decode
    steps: logits, and the rings' positions, against JAX's."""
    cfg, jcfg, params, jp = _setup(variant)
    toks = _tokens(cfg, (2, 78), seed=2)
    P = 70
    jpre = jax_forward(jp, jcfg, {"tokens": jnp.asarray(toks[:, :P])},
                       mode="prefill")
    with torch.no_grad():
        pre = forward(params, cfg, {"tokens": torch.from_numpy(toks[:, :P])},
                      mode="prefill")
    np.testing.assert_allclose(pre["logits"].numpy(), _np(jpre["logits"]),
                               atol=LOGITS_ATOL, rtol=0)
    cache, jcache = pre["cache"], jpre["cache"]
    napps = n_attn_apps(cfg)
    assert cache["attn"].k.shape == (napps, 2, cfg.n_kv_heads, 64,
                                     cfg.head_dim)
    assert cache["ssm"].h.shape[0] == cfg.n_layers
    np.testing.assert_array_equal(cache["attn"].pos.numpy(),
                                  np.asarray(jcache["attn"].pos))
    jdec = jax.jit(lambda c, t, s: jax_decode_step(jp, jcfg, c,
                                                   {"tokens": t}, s))
    for i in range(P, toks.shape[1]):
        jd = jdec(jcache, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        jcache = jd["cache"]
        with torch.no_grad():
            d = decode_step(params, cfg, cache,
                            {"tokens": torch.from_numpy(toks[:, i:i + 1])}, i)
        np.testing.assert_allclose(d["logits"].numpy(), _np(jd["logits"]),
                                   atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_array_equal(cache["attn"].pos.numpy(),
                                  np.asarray(jcache["attn"].pos))
    np.testing.assert_allclose(cache["ssm"].h.numpy(),
                               _np(jcache["ssm"].h), atol=LOGITS_ATOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_step_loss_and_gradients_vs_jax(variant):
    cfg, jcfg, params, jp = _setup(variant, seed=3)
    toks = _tokens(cfg, (2, 72), seed=3)
    grads, m = loss_and_grads(make_loss_fn(cfg, "lm"), params,
                              {"tokens": torch.from_numpy(toks)})
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, jcfg, {"tokens": jnp.asarray(toks)})[
            "loss"]))(jp)
    np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=LOSS_RTOL)
    want = jax_flat(jg)
    assert set(grads) == set(want)
    assert any(k.startswith("shared_attn/") for k in grads)
    for k, g in grads.items():
        scale = float(np.abs(want[k]).max())
        err = float(np.abs(g.numpy() - want[k]).max())
        assert scale > 0 and err <= GRAD_REL * scale, (k, err, scale)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _requests(cfg, lens, max_new, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, S).astype(np.int32),
             rng.random((max_new, cfg.vocab_size), dtype=np.float32))
            for S in lens]


def _serve(params, cfg, reqs, *, slots, max_context, max_new, **kw):
    eng = BatchedEngine(params, cfg, slots=slots, max_context=max_context,
                        device="cpu", **kw)
    rs = [Request(tokens=t, max_new=max_new, uniforms=u) for t, u in reqs]
    for r in rs:
        eng.submit(r)
    eng.run()
    assert all(r.done and r.error is None for r in rs)
    assert eng.host_syncs == eng.ticks + eng.admit_batches
    return eng, rs


def test_engine_equals_straight_line_oracle():
    """Four requests (two past the window) through three slots, one solo
    exact-length prefill each: every request's tokens equal the
    straight-line oracle's for it alone, bit for bit."""
    cfg, _, params, _ = _setup("periodic")
    reqs = _requests(cfg, (20, 70, 5, 100), max_new=6, seed=4)
    eng, rs = _serve(params, cfg, reqs, slots=3, max_context=CTX, max_new=6)
    assert eng.cache["attn"].k.shape[3] == 64        # the window, not 128
    assert sorted(eng.prefill_shapes) == [(1, 5), (1, 20), (1, 70),
                                          (1, 100)]
    assert eng.admit_batches == 4
    for (toks, u), r in zip(reqs, rs):
        want = ring_reference_futures(params, cfg, toks, n=1, max_new=6,
                                      uniforms=u[None], slots=3,
                                      max_context=CTX, device="cpu")
        assert r.out_tokens == want[0][0]


def test_held_parent_forks_equal_immediate_forks_and_oracle():
    """A parent held while other traffic ticks (its parked rows advance the
    Mamba state and write a discarded token into its rings), then forked
    into 4 children: the children equal 4 immediate forks and the oracle,
    bit for bit."""
    cfg, _, params, _ = _setup("periodic")
    toks = _tokens(cfg, 70, seed=5)
    us = np.random.default_rng(6).random((4, 6, cfg.vocab_size),
                                         dtype=np.float32)
    want = ring_reference_futures(params, cfg, toks, n=4, max_new=6,
                                  uniforms=us, slots=5, max_context=CTX,
                                  device="cpu")
    eng = BatchedEngine(params, cfg, slots=5, max_context=CTX, device="cpu")
    now = eng.sample_futures(toks, n=4, max_new=6, uniforms=us)
    assert [k.out_tokens for k in now] == [t for t, _ in want]

    eng = BatchedEngine(params, cfg, slots=5, max_context=CTX, device="cpu")
    parent = Request(tokens=toks, max_new=6, hold=True)
    eng.submit(parent)
    (t, u), = _requests(cfg, (30,), max_new=8, seed=7)
    other = Request(tokens=t, max_new=8, uniforms=u)
    eng.submit(other)
    for _ in range(4):
        eng.step()
    assert eng.ticks >= 3 and not parent.done
    kids = [Request(tokens=toks, max_new=6, uniforms=us[i]) for i in range(4)]
    eng.fork(parent.request_id, children=kids)
    eng.run()
    assert [k.out_tokens for k in kids] == [k.out_tokens for k in now]
    assert other.done and len(other.out_tokens) == 8


def test_fork_copy_masks_every_ring_past_the_prompt():
    cfg, _, params, _ = _setup("periodic")
    cache = make_decode_cache(params, cfg, 3, CTX)
    lc = cache["attn"]
    lc.pos[:, 0, :10] = torch.arange(10, dtype=torch.int32)
    lc.pos[:, 0, 12] = 40                              # a parked tick's write
    cache["ssm"].h[:, 0] = 1.0
    _fork_copy_rows(cache, 0, [1, 2], 9)
    for s in (1, 2):
        assert int(lc.pos[:, s].max()) == 9 and int(lc.pos[:, s, 12].max()) == -1
        assert bool((cache["ssm"].h[:, s] == 1.0).all())
    assert int(lc.pos[:, 0, 12].min()) == 40           # the parent's row stays


def test_engine_refuses_the_paged_cache():
    cfg, _, params, _ = _setup()
    with pytest.raises(ValueError, match="attention-cache architecture"):
        BatchedEngine(params, cfg, slots=2, max_context=CTX, cache="paged",
                      device="cpu")


def test_engine_vs_jax_engine():
    """Both engines at ``max_context`` 64 (the JAX engine's prefill rings
    are ``max_context`` wide and must match its window-wide slot rings):
    the port's tokens held step by step against the JAX model's Gumbel
    scores (margin 1e-4), and the two free runs compared up to their first
    divergence."""
    cfg, jcfg, params, jp = _setup("periodic", seed=8)
    reqs = _requests(cfg, (30, 12, 25), max_new=6, seed=9)
    jeng = JaxEngine(jp, jcfg, slots=2, max_context=64)
    jrs = [JaxRequest(tokens=t, max_new=6, uniforms=u) for t, u in reqs]
    for r in jrs:
        jeng.submit(r)
    jeng.run()
    eng, rs = _serve(params, cfg, reqs, slots=2, max_context=64, max_new=6)
    jf = jax.jit(lambda t: jax_forward(jp, jcfg, {"tokens": t})["logits"])
    held = check_lm_trajectories(
        [t for t, _ in reqs], [r.out_tokens for r in rs],
        [u for _, u in reqs],
        lambda t, a: np.asarray(jf(jnp.asarray(t, jnp.int32))),
        margin_tol=1e-4)
    assert held["steps"] == 18
    free = compare_runs([(r.out_tokens, []) for r in jrs],
                        [(r.out_tokens, []) for r in rs], age_rtol=0.0)
    assert free["compared"] >= len(reqs)


# ---------------------------------------------------------------------------
# the CLIs and checkpoints
# ---------------------------------------------------------------------------
def test_serve_and_train_clis_on_the_cpu(monkeypatch, capsys, tmp_path):
    """``--arch zamba2-1.2b`` through both CLIs at the reduced size (the
    serve CLI's synthetic prompts need a vocabulary that holds their event
    ids), and the trained checkpoint served through ``--ckpt``."""
    real = launch.get_config

    def small(arch, reduced=False):
        return real(arch, reduced=True).replace(vocab_size=2048)
    monkeypatch.setattr(launch, "get_config", small)
    monkeypatch.setattr(launch_train, "get_config", small)
    out = launch.main(["--arch", "zamba2-1.2b", "--requests", "3", "--slots",
                       "2", "--max-new", "4", "--device", "cpu"])
    eng = out["engine"]
    assert len(out["done"]) == 3 and out["events"] == 12
    assert eng.cache["attn"].k.shape[3] == 64        # the window's ring
    assert all(nb == 1 for nb, _ in eng.prefill_shapes)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
    tr = launch_train.main(["--arch", "zamba2-1.2b", "--reduced", "--steps",
                            "2", "--batch", "2", "--seq-len", "40",
                            "--device", "cpu", "--out", str(tmp_path)])
    assert tr["cfg"].arch_type == "hybrid"
    assert np.isfinite(tr["history"]["loss"]).all()
    out = launch.main(["--arch", "zamba2-1.2b", "--requests", "2", "--slots",
                       "2", "--max-new", "2", "--device", "cpu", "--ckpt",
                       str(tmp_path), "--max-context", "64"])
    assert out["events"] == 4


def test_checkpoints_both_ways_keep_attn_every(tmp_path):
    cfg, jcfg, params, jp = _setup("periodic", seed=10)
    jax_ckpt.save(str(tmp_path / "jax"), jp, jcfg)
    lcfg, _ = checkpoint.load_config(str(tmp_path / "jax"))
    assert (lcfg.arch_type, lcfg.attn_every, lcfg.n_layers) == (
        "hybrid", 2, 5)
    back = checkpoint.restore(str(tmp_path / "jax"),
                              init_params(lcfg, seed=0, device="cpu"))
    assert all(torch.equal(back[k], params[k]) for k in params)
    checkpoint.save(str(tmp_path / "port"), params, cfg)
    jcfg2, _ = jax_ckpt.load_config(str(tmp_path / "port"))
    assert (jcfg2.arch_type, jcfg2.attn_every) == ("hybrid", 2)
    jback = jax_ckpt.restore(str(tmp_path / "port"),
                             jax_init_params(jcfg2, jax.random.PRNGKey(0)))
    flat = jax_flat(jback)
    assert all((flat[k] == params[k].numpy()).all() for k in params)
    assert isinstance(make_decode_cache(params, cfg, 1, 32)["attn"],
                      LayerCache)
