"""The port's vision-language family (InternVL2-26B: the dense decoder over
patch embeddings put before the text) against the JAX package's, on the
CPU in fp32 at the reduced config (2 layers, d_model 256, GQA 4/1, 8 patch
tokens).

Weights: the port's numpy-seeded ``init_params``, handed to the JAX model
through the flat checkpoint layout; inputs from numpy seeds.

Tolerances, measured on these inputs (CPU, fp32):
* Logits (train, both routes; prefill at each row's last valid text token
  of a right-padded batch; three decode steps on the ring and on a paged
  pool; a suffix prefill over the patches' context; a JAX checkpoint's)
  and the prefill's ring K/V: within 5.9e-6 (allowed ``LM_ATOL`` 5e-5,
  the dense LMs' allowance); ring positions equal.
* The port's own decode parity (``tests/test_models_smoke.py``'s:
  decode after prefill(x[:-1]) == forward(x) at the last position):
  measured 0, allowed 3e-4, JAX's own tolerance there.
* ``lm_loss`` within 1e-5 relative of ``jax.grad``'s; every gradient
  within 1e-2 of its leaf's largest |g|; one AdamW step's params within
  1e-6 where JAX's |g| > 2e-4 and everywhere within 2 lr (Adam's first
  step is ~lr * sign(g): ``tests/test_torch_train.py``'s rule).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import forward_suffix as jax_forward_suffix
from repro.models import init_params as jax_init_params
from repro.models import mask_padded_positions as jax_mask
from repro.models.attention import PagedCache as JaxPagedCache
from repro.serve import BatchedEngine as JaxEngine
from repro.train import checkpoint as jax_ckpt
from repro.train import optimizer as jopt
from repro.train.trainer import lm_loss as jax_lm_loss
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch.api import LocalBackend
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.models import (PagedCache, decode_step, forward,
                                forward_suffix, init_params,
                                init_params_on_device, load_checkpoint,
                                make_decode_cache, make_paged_decode_cache,
                                mask_padded_positions, to_flat_numpy)
from repro_torch.models.params import MATMUL_KEYS
from repro_torch.sdk import export_model
from repro_torch.serve import BatchedEngine
from repro_torch.train import (OptimizerConfig, checkpoint, init_opt_state,
                               loss_and_grads, make_loss_fn, make_train_step)

torch.set_num_threads(2)

ARCH = "internvl2-26b"
LM_ATOL = 5e-5
PARITY_ATOL = 3e-4
LOSS_RTOL = 1e-5
GRAD_REL = 1e-2
GRAD_SIGNIFICANT = 2e-4
PARAM_ATOL = 1e-6
LR = 1e-3
FRONTEND_FIELDS = ("frontend", "n_frontend_tokens", "n_encoder_layers",
                   "enc_len_ratio", "dec_enc_len")


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
def _setup():
    cfg = get_config(ARCH, reduced=True).replace(dtype="float32")
    jcfg = jax_config(ARCH, reduced=True).replace(dtype="float32")
    params = init_params(cfg, seed=1, device="cpu")
    return cfg, jcfg, params, jax_params(to_flat_numpy(params))


def _batch(cfg, B, S, seed):
    """tokens (B, S) and patches (B, P, d) from numpy seeds."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
            .astype(np.int32),
            "patches": rng.standard_normal(
                (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(a, b, atol=LM_ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# the config and the weights
# ---------------------------------------------------------------------------
def test_config_equals_jax():
    """Every field of the full and the reduced config equals JAX's; the
    registry holds JAX's 12 names."""
    from repro.configs import ALL_ARCHS as JAX_ARCHS
    assert sorted(ALL_ARCHS) == sorted(JAX_ARCHS) and len(ALL_ARCHS) == 12
    for red in (False, True):
        mine, want = get_config(ARCH, reduced=red), jax_config(ARCH,
                                                               reduced=red)
        for f in mine.__dataclass_fields__:
            assert getattr(mine, f) == getattr(want, f), (red, f)
        assert mine.has_encoder == want.has_encoder is False
    red = get_config(ARCH, reduced=True)
    assert (red.n_frontend_tokens, red.frontend, red.q_per_kv) == (
        8, "vision_patches", 4)


def test_param_keys_and_shapes_equal_jax(tmp_path):
    """JAX ``init_params`` -> npz -> the port -> back, exactly (a VLM has
    the dense leaves and no more; an fp32 config: every leaf's use dtype
    fp32); both of the port's initialisers make JAX's keys and shapes, the
    device route and the loader under the bf16 config their MATMUL_KEYS
    leaves in the activation dtype (the loader's: the file's values
    rounded)."""
    cfg = get_config(ARCH, reduced=True)
    flat = jax_flat(jax_init_params(jax_config(ARCH, reduced=True),
                                    jax.random.PRNGKey(2)))
    np.savez(tmp_path / "params.npz", **flat)
    params = load_checkpoint(str(tmp_path), cfg.replace(dtype="float32"),
                             device="cpu")
    back = to_flat_numpy(params)
    assert set(back) == set(flat)
    assert all((back[k] == flat[k]).all() for k in flat)
    want = {k: v.shape for k, v in flat.items()}
    for made in (init_params(cfg, seed=0, device="cpu"),
                 init_params_on_device(cfg, seed=0, device="cpu")):
        assert {k: tuple(v.shape) for k, v in made.items()} == want
    dev = init_params_on_device(cfg, seed=0, device="cpu")
    loaded = load_checkpoint(str(tmp_path), cfg, device="cpu")
    for k, v in dev.items():
        assert v.dtype == loaded[k].dtype == (
            torch.bfloat16 if k in MATMUL_KEYS else torch.float32), k
        assert torch.equal(loaded[k], params[k].to(v.dtype)), k


# ---------------------------------------------------------------------------
# forward, prefill, decode against JAX
# ---------------------------------------------------------------------------
def _paged_layout(k, v, pos, bs, seed):
    """A ring (L, B, Hkv, W, hd) and its positions laid out as a pool of
    ``bs``-token blocks at shuffled ids (block 0 the trash block)."""
    L, B, Hkv, W, hd = k.shape
    nbs = W // bs
    ids = np.random.default_rng(seed).permutation(B * nbs) + 1
    table = ids.reshape(B, nbs).astype(np.int32)
    NB = B * nbs + 1
    kp = np.zeros((L, NB, Hkv, bs, hd), k.dtype)
    vp = np.zeros_like(kp)
    pp = np.full((NB, bs), -1, np.int32)
    for b in range(B):
        for j in range(nbs):
            sl = slice(j * bs, (j + 1) * bs)
            kp[:, table[b, j]] = k[:, b, :, sl]
            vp[:, table[b, j]] = v[:, b, :, sl]
            pp[table[b, j]] = pos[0, b, sl]
    return kp, vp, pp, table


@pytest.mark.parametrize("kind", ["train", "prefill", "decode-ring",
                                  "decode-paged"])
def test_reduced_vlm_vs_jax(kind):
    """The train logits over patches and text (both routes, and
    ``text_offset``); the prefill logits at each row's last valid text
    token of a right-padded batch (``last_index`` counts text) and its
    ring; three decode steps from that prefill (padded positions masked,
    the step the absolute position: patches + text) on the ring and on a
    paged pool holding the same tokens in shuffled blocks."""
    cfg, jcfg, params, jp = _setup()
    P = cfg.n_frontend_tokens
    b = _batch(cfg, 2, 56, seed=0)
    if kind == "train":
        with torch.no_grad():
            mine = forward(params, cfg, _t(b), mode="train")
            diff = forward(params, cfg, _t(b), mode="train",
                           differentiable=True)
        want = jax_forward(jp, jcfg, _j(b), mode="train")
        assert mine["text_offset"] == want["text_offset"] == P
        assert mine["logits"].shape == (2, P + 56, cfg.vocab_size)
        for out in (mine, diff):
            _close(out["logits"], want["logits"])
        return
    W = 96
    last = np.asarray([55, 30], np.int32)
    with torch.no_grad():
        pre = forward(params, cfg, _t(b), mode="prefill", cache_width=W,
                      last_index=torch.from_numpy(last))
    jpre = jax_forward(jp, jcfg, _j(b), mode="prefill", cache_width=W,
                       last_index=jnp.asarray(last))
    if kind == "prefill":
        _close(pre["logits"], jpre["logits"])
        ring, jring = pre["cache"]["self"], jpre["cache"]["self"]
        assert set(pre["cache"]) == set(jpre["cache"]) == {"self"}
        _close(ring.k, jring.k)
        _close(ring.v, jring.v)
        assert (ring.pos.numpy() == np.asarray(jring.pos)).all()
        assert int(ring.pos.max()) == P + 56 - 1
        return
    cache = mask_padded_positions(pre["cache"], torch.from_numpy(last + P))
    jcache = jax_mask(jpre["cache"], jnp.asarray(last + P))
    if kind == "decode-paged":
        lc = cache["self"]
        kp, vp, pp, table = _paged_layout(lc.k.numpy(), lc.v.numpy(),
                                          lc.pos.numpy(), 16, seed=3)
        cache = {"self": PagedCache(*(torch.from_numpy(a.copy())
                                      for a in (kp, vp, pp, table)))}
        jcache = {"self": JaxPagedCache(*(jnp.asarray(a)
                                          for a in (kp, vp, pp, table)))}
    step = last + 1 + P
    rng = np.random.default_rng(1)
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        with torch.no_grad():
            d = decode_step(params, cfg, cache,
                            {"tokens": torch.from_numpy(tok)},
                            torch.from_numpy(step))
        jd = jax_decode_step(jp, jcfg, jcache, {"tokens": jnp.asarray(tok)},
                             jnp.asarray(step))
        jcache = jd["cache"]
        _close(d["logits"], jd["logits"])
        step = step + 1


def test_decode_parity():
    """``tests/test_models_smoke.py::test_decode_parity`` on the port: one
    decode step (at ``n_frontend_tokens`` + the text position) after a
    prefill of x[:-1] == the forward of x at its last position, on the
    ring from ``forward`` and on an empty ``make_decode_cache`` ring
    holding the same prefill."""
    cfg, _, params, _ = _setup()
    B, S, P = 2, 33, cfg.n_frontend_tokens
    b = _t(_batch(cfg, B, S, seed=4))
    with torch.no_grad():
        full = forward(params, cfg, b, mode="train")["logits"][:, -1]
        pb = {"tokens": b["tokens"][:, :S - 1], "patches": b["patches"]}
        pre = forward(params, cfg, pb, mode="prefill", cache_width=64)
        fresh = make_decode_cache(params, cfg, B, 64)
        for f in ("k", "v", "pos"):
            getattr(fresh["self"], f).copy_(getattr(pre["cache"]["self"], f))
        step = torch.full((B,), S - 1 + P, dtype=torch.int32)
        db = {"tokens": b["tokens"][:, S - 1:]}
        d = decode_step(params, cfg, pre["cache"], db, step)
        d2 = decode_step(params, cfg, fresh, db, step)
    _close(d["logits"][:, 0], full, atol=PARITY_ATOL)
    assert torch.equal(d2["logits"], d["logits"])


def test_vlm_frontend_prepended():
    """``tests/test_models_smoke.py::test_vlm_frontend_prepended`` on the
    port: ``text_offset`` is the patch count, and the patches move the text
    logits (information crosses the boundary)."""
    cfg, _, params, _ = _setup()
    b = _t(_batch(cfg, 2, 16, seed=5))
    with torch.no_grad():
        out = forward(params, cfg, b, mode="train")
        out2 = forward(params, cfg, {**b, "patches": b["patches"] + 1.0},
                       mode="train")
    assert out["text_offset"] == cfg.n_frontend_tokens
    assert float((out["logits"] - out2["logits"]).abs().max()) > 1e-3
    text = slice(cfg.n_frontend_tokens, None)
    assert float((out["logits"][:, text] - out2["logits"][:, text])
                 .abs().max()) > 1e-3


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


def test_lm_loss_and_grads_vs_jax():
    """``lm_loss`` over the text only (the first ``text_offset`` logits
    dropped, as JAX's) and every gradient against ``jax.grad``."""
    cfg, jcfg, params, jp = _setup()
    b = _batch(cfg, 2, 40, seed=6)
    grads, m = loss_and_grads(make_loss_fn(cfg, "lm"), params, _t(b))
    (_, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: (lambda mm: (mm["loss"], mm))(jax_lm_loss(p, jcfg, _j(b))),
        has_aux=True))(jp)
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    _check_grads(grads, jax_flat(jg))


def test_train_step_vs_jax():
    """One ``make_train_step`` (gradients, clip, AdamW) from the same
    params and batch as JAX's."""
    cfg, jcfg, params, jp = _setup()
    b = _batch(cfg, 2, 40, seed=7)
    kw = dict(lr=LR, warmup_steps=0, total_steps=10)
    new, state, m = make_train_step(cfg, OptimizerConfig(**kw), "lm")(
        params, init_opt_state(params), _t(b))
    jnew, _, jm = jax.jit(jax_make_train_step(
        jcfg, jopt.OptimizerConfig(**kw), "lm"))(
        jp, jopt.init_opt_state(jp), _j(b))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    assert int(state["step"]) == 1
    jg = jax_flat(jax.grad(lambda p: jax_lm_loss(p, jcfg, _j(b))["loss"])(jp))
    jnew = jax_flat(jnew)
    for k in new:
        assert not new[k].requires_grad
        d = np.abs(new[k].numpy() - jnew[k])
        sig = np.abs(jg[k]) > GRAD_SIGNIFICANT
        assert d[sig].max(initial=0.0) <= PARAM_ATOL, k
        assert d.max() <= 2 * LR * 1.01, k


# ---------------------------------------------------------------------------
# the paged cache, suffix prefill, checkpoints, refusals
# ---------------------------------------------------------------------------
def test_paged_cache_and_forward_suffix_accept_vlm():
    """As JAX's, ``make_paged_decode_cache`` and ``forward_suffix`` take a
    VLM: a text chunk attends over a context holding the patches and the
    first text tokens; its logits equal JAX's and the whole prefill's, and
    its K/V the whole prefill's ring rows."""
    cfg, jcfg, params, jp = _setup()
    pc = make_paged_decode_cache(params, cfg, 2, 64, num_blocks=9,
                                 block_size=16)
    assert pc["self"].k.shape == (cfg.n_layers, 9, 1, 16, cfg.head_dim)
    P, S, C = cfg.n_frontend_tokens, 40, 24
    b = _batch(cfg, 2, S, seed=8)
    with torch.no_grad():
        whole = forward(params, cfg, _t(b), mode="prefill", cache_width=64)
        head = forward(params, cfg, {"tokens": _t(b)["tokens"][:, :C],
                                     "patches": _t(b)["patches"]},
                       mode="prefill", cache_width=64)
    ring = head["cache"]["self"]
    n = P + C
    ctx = {"k": ring.k[:, :, :, :n].transpose(2, 3).contiguous(),
           "v": ring.v[:, :, :, :n].transpose(2, 3).contiguous(),
           "pos": ring.pos[0, :, :n].contiguous()}
    pos = torch.arange(n, P + S, dtype=torch.int32).expand(2, S - C)
    sb = {"tokens": _t(b)["tokens"][:, C:], "positions": pos}
    last = torch.full((2,), S - C - 1, dtype=torch.int32)
    with torch.no_grad():
        out = forward_suffix(params, cfg, sb, ctx, last_index=last)
    jout = jax_forward_suffix(
        jp, jcfg, {k: jnp.asarray(v.numpy()) for k, v in sb.items()},
        {k: jnp.asarray(v.numpy()) for k, v in ctx.items()},
        last_index=jnp.asarray(last.numpy()))
    _close(out["logits"], jout["logits"])
    _close(out["k"], jout["k"])
    _close(out["logits"], whole["logits"])
    wk = whole["cache"]["self"].k[:, :, :, n:P + S].transpose(2, 3)
    _close(out["k"], wk)


def test_checkpoints_both_ways_keep_the_frontend_fields(tmp_path):
    """A JAX VLM checkpoint (``n_frontend_tokens`` changed from the
    config's own, so that a dropped field would show) loads in the port
    with every frontend field and the right shapes, and its logits equal
    JAX's; the port's save of the same weights loads in JAX."""
    jcfg = jax_config(ARCH, reduced=True).replace(dtype="float32",
                                                  n_frontend_tokens=5)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(4))
    jax_ckpt.save(str(tmp_path / "jax"), jp, jcfg)
    cfg, _ = checkpoint.load_config(str(tmp_path / "jax"))
    for f in FRONTEND_FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.n_frontend_tokens == 5 and cfg.arch_type == "vlm"
    params = load_checkpoint(str(tmp_path / "jax"), cfg, device="cpu")
    b = _batch(cfg, 1, 12, seed=9)
    assert b["patches"].shape[1] == 5
    with torch.no_grad():
        mine = forward(params, cfg, _t(b), mode="train")["logits"]
    _close(mine, jax_forward(jp, jcfg, _j(b), mode="train")["logits"])
    checkpoint.save(str(tmp_path / "port"), params, cfg)
    jcfg2, _ = jax_ckpt.load_config(str(tmp_path / "port"))
    assert jcfg2 == jcfg
    jback = jax_flat(jax_ckpt.restore(
        str(tmp_path / "port"), jax_init_params(jcfg2,
                                                jax.random.PRNGKey(0))))
    assert set(jback) == set(params)
    assert all((jback[k] == params[k].numpy()).all() for k in jback)


def test_engine_local_backend_and_export_refuse_as_jax(tmp_path):
    """The reference's engine refuses a frontend config with
    ``ValueError("engine serves token-only architectures")``; the port's
    engine and ``LocalBackend`` raise the same (the reference's
    ``LocalBackend`` fails later, with a ``KeyError`` on the missing
    patches), and ``export_model`` refuses it by name."""
    cfg, jcfg, params, jp = _setup()
    msg = "engine serves token-only architectures"
    with pytest.raises(ValueError, match=msg):
        JaxEngine(jp, jcfg, slots=2, max_context=64)
    with pytest.raises(ValueError, match=msg):
        BatchedEngine(params, cfg, slots=2, max_context=64, device="cpu")
    with pytest.raises(ValueError, match=msg):
        LocalBackend(params, cfg, seq_len=64, device="cpu")
    with pytest.raises(NotImplementedError, match="patches"):
        export_model(params, cfg, str(tmp_path / "art"), seq_len=64)
