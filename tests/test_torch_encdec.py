"""The port's encoder-decoder family (SeamlessM4T-large-v2: a bidirectional
encoder over frame embeddings, a causal decoder with cross-attention to
its output) against the JAX package's, on the CPU in fp32 at the reduced
config (2 + 2 layers, d_model 256, 4/4 heads of 64, LayerNorm, GELU, an
encoder memory of 64 for the decode shapes).

Weights: the port's numpy-seeded ``init_params``, handed to the JAX model
through the flat checkpoint layout (QKV biases, which JAX initialises to
zero, drawn where a case has them); inputs from numpy seeds.

Tolerances, measured on these inputs (CPU, fp32):
* Logits (train, both routes; prefill at each row's last valid token of a
  right-padded batch; four decode steps; a JAX checkpoint's) and the
  prefill's self and cross rings' K/V: within 3.8e-6 (allowed
  ``LM_ATOL`` 5e-5, the dense LMs' allowance); ring positions equal.
* The bidirectional attention entries (``full_attention`` on the CPU, the
  training route's ``chunked_attention(causal=False)``) against JAX's
  ``chunked_attention(causal=False)`` with T != S, past the 512 x 512
  blocked threshold too, and the cross decode against JAX's
  ``decode_attention``: within 4.8e-7 (allowed 1e-5).
* The port's own decode parity (``tests/test_models_smoke.py``'s):
  measured 2.4e-6, allowed 3e-4, JAX's own tolerance there.
* ``lm_loss`` within 1e-5 relative of ``jax.grad``'s; every gradient
  within 1e-2 of its leaf's largest |g|, but the cross-attention's key
  bias's, whose exact gradient is zero: both packages' within 1e-5 of the
  largest |g| of all leaves; one AdamW step's params within 1e-6 where JAX's |g| > 2e-4 and
  everywhere within 2 lr.
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
from repro.models import make_decode_cache as jax_make_decode_cache
from repro.models import make_paged_decode_cache as jax_make_paged
from repro.models import mask_padded_positions as jax_mask
from repro.models.attention import chunked_attention as jax_chunked
from repro.models.attention import decode_attention as jax_decode_attention
from repro.models.attention import LayerCache as JaxLayerCache
from repro.serve import BatchedEngine as JaxEngine
from repro.train import checkpoint as jax_ckpt
from repro.train import optimizer as jopt
from repro.train.trainer import lm_loss as jax_lm_loss
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch.api import LocalBackend
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.models import (decode_step, forward, forward_suffix,
                                init_params, init_params_on_device,
                                load_checkpoint, make_decode_cache,
                                make_paged_decode_cache,
                                mask_padded_positions, to_flat_numpy)
from repro_torch.models import attention as attn
from repro_torch.models.params import MATMUL_KEYS, param_shapes
from repro_torch.sdk import export_model
from repro_torch.serve import BatchedEngine
from repro_torch.train import (OptimizerConfig, checkpoint, init_opt_state,
                               loss_and_grads, make_loss_fn, make_train_step)

torch.set_num_threads(2)

ARCH = "seamless-m4t-large-v2"
LM_ATOL = 5e-5
ATTN_ATOL = 1e-5
PARITY_ATOL = 3e-4
LOSS_RTOL = 1e-5
GRAD_REL = 1e-2
ZERO_GRAD_REL = 1e-5
GRAD_SIGNIFICANT = 2e-4
PARAM_ATOL = 1e-6
LR = 1e-3
ENCODER_FIELDS = ("n_encoder_layers", "enc_len_ratio", "dec_enc_len",
                  "frontend", "n_frontend_tokens")
# (replaced fields): the reduced SeamlessM4T; the same as arch "enc_dec"
# (the reference's other encoder-decoder family); with QKV biases (the
# cross-attention's too) and GQA 4/2
VARIANTS = {"seamless": {}, "enc_dec": {"arch_type": "enc_dec"},
            "bias-gqa": {"qkv_bias": True, "n_kv_heads": 2}}


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
def _setup(variant="seamless"):
    change = VARIANTS[variant]
    cfg = get_config(ARCH, reduced=True).replace(dtype="float32", **change)
    jcfg = jax_config(ARCH, reduced=True).replace(dtype="float32", **change)
    params = init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(7)
    for k in list(params):
        if k.rsplit("/", 1)[-1] in ("bq", "bk", "bv"):
            params[k] = torch.from_numpy(
                (0.5 * rng.standard_normal(tuple(params[k].shape)))
                .astype(np.float32))
    return cfg, jcfg, params, jax_params(to_flat_numpy(params))


def _batch(cfg, B, S, M, seed):
    """tokens (B, S) and frames (B, M, d) from numpy seeds."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
            .astype(np.int32),
            "frames": rng.standard_normal((B, M, cfg.d_model))
            .astype(np.float32)}


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
    """Every field of the full and the reduced config equals JAX's."""
    for red in (False, True):
        mine, want = get_config(ARCH, reduced=red), jax_config(ARCH,
                                                               reduced=red)
        for f in mine.__dataclass_fields__:
            assert getattr(mine, f) == getattr(want, f), (red, f)
        assert mine.has_encoder and want.has_encoder
    red = get_config(ARCH, reduced=True)
    assert (red.n_encoder_layers, red.dec_enc_len) == (2, 64)
    full = get_config(ARCH)
    assert (full.n_layers, full.n_encoder_layers, full.vocab_size) == (
        24, 24, 256206)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_param_keys_and_shapes_equal_jax(variant, tmp_path):
    """JAX ``init_params`` (``encoder/*``, ``enc_norm/*``,
    ``layers/cross_norm/*``, ``layers/cross_attn/*``) -> npz -> the port ->
    back, exactly (an fp32 config: every leaf's use dtype fp32); both of
    the port's initialisers make JAX's keys and shapes, the device route
    and the loader under the bf16 config their MATMUL_KEYS leaves (the
    encoder's and the cross-attention's among them) in the activation
    dtype, and ``cast_params`` casts them to the loader's bits."""
    from repro_torch.models import cast_params
    change = VARIANTS[variant]
    cfg = get_config(ARCH, reduced=True).replace(**change)
    flat = jax_flat(jax_init_params(
        jax_config(ARCH, reduced=True).replace(**change),
        jax.random.PRNGKey(2)))
    assert {k.split("/")[0] for k in flat} == {
        "embed", "encoder", "enc_norm", "final_norm", "layers"}
    assert "layers/cross_attn/wq" in flat and "encoder/attn/wo" in flat
    np.savez(tmp_path / "params.npz", **flat)
    params = load_checkpoint(str(tmp_path), cfg.replace(dtype="float32"),
                             device="cpu")
    back = to_flat_numpy(params)
    assert set(back) == set(flat) == set(param_shapes(cfg))
    assert all((back[k] == flat[k]).all() for k in flat)
    want = {k: v.shape for k, v in flat.items()}
    dev = init_params_on_device(cfg, seed=0, device="cpu")
    for made in (init_params(cfg, seed=0, device="cpu"), dev):
        assert {k: tuple(v.shape) for k, v in made.items()} == want
    matmul = {k for k in flat if k in MATMUL_KEYS}
    assert {"encoder/attn/wq", "encoder/mlp/w_fc", "layers/cross_attn/wk",
            "layers/cross_attn/wo"} <= matmul
    assert not any("norm" in k for k in matmul)
    for k, v in dev.items():
        assert v.dtype == (torch.bfloat16 if k in matmul
                           else torch.float32), k
    cast = cast_params(params, cfg)
    assert all(cast[k].dtype == torch.bfloat16 for k in matmul)
    loaded = load_checkpoint(str(tmp_path), cfg, device="cpu")
    for k, v in loaded.items():
        assert v.dtype == dev[k].dtype and torch.equal(v, cast[k]), k


def test_init_scales_follow_jax():
    """The reference's scales on the new leaves (both routes): d^-0.5 for
    the encoder's and the cross-attention's q/k/v, (H hd)^-0.5 for their
    output projections; the cross and encoder norms start at 1 and 0."""
    cfg = get_config(ARCH, reduced=True).replace(dtype="float32")
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    want = {"encoder/attn/wq": d ** -0.5, "layers/cross_attn/wk": d ** -0.5,
            "layers/cross_attn/wo": (H * hd) ** -0.5,
            "encoder/mlp/w_proj": cfg.d_ff ** -0.5}
    for made in (init_params(cfg, seed=0, device="cpu"),
                 init_params_on_device(cfg, seed=0, device="cpu")):
        for k, s in want.items():
            assert abs(float(made[k].float().std()) / s - 1) < 0.05, k
        assert bool((made["layers/cross_norm/scale"] == 1).all())
        assert bool((made["enc_norm/bias"] == 0).all())


# ---------------------------------------------------------------------------
# the attention entries
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,T,Hq,Hkv", [(24, 40, 4, 4), (600, 700, 4, 2),
                                        (64, 4, 4, 4)])
def test_bidirectional_attention_vs_jax(S, T, Hq, Hkv):
    """The non-causal entry (``full_attention``: the flash kernel's
    non-causal route on the card, its plain version here) and the training
    route (``chunked_attention(causal=False)``, dense and blocked) against
    JAX's ``chunked_attention(causal=False)`` with T keys for S queries."""
    rng = np.random.default_rng(S)
    q = rng.standard_normal((2, S, Hq, 64)).astype(np.float32)
    k = rng.standard_normal((2, T, Hkv, 64)).astype(np.float32)
    v = rng.standard_normal((2, T, Hkv, 64)).astype(np.float32)
    qp, kp = np.arange(S, dtype=np.int32), np.arange(T, dtype=np.int32)
    want = jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(qp), jnp.asarray(kp), causal=False,
                       window=None, q_per_kv=Hq // Hkv)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    _close(attn.full_attention(tq, tk, tv), want, atol=ATTN_ATOL)
    _close(attn.chunked_attention(tq, tk, tv, torch.from_numpy(qp),
                                  torch.from_numpy(kp), causal=False,
                                  q_per_kv=Hq // Hkv), want, atol=ATTN_ATOL)


def test_cross_decode_reads_every_memory_position_as_jax():
    """Cross-attention's decode against a full cross ring (positions
    0..W-1) equals JAX's ``decode_attention`` at the reference's step
    ``2**30``, and is not zeros.  The trap it avoids: the paged kernel and
    its plain version apply ``pos > step - W`` always (JAX only with a
    deferred write), so at step ``2**30`` they mask every position and
    return zeros; ``cross_decode_attention`` passes the largest memory
    position, W - 1."""
    B, Hkv, G, W, hd = 3, 2, 2, 24, 64
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, 1, Hkv * G, hd)).astype(np.float32)
    k = rng.standard_normal((1, B, Hkv, W, hd)).astype(np.float32)
    v = rng.standard_normal((1, B, Hkv, W, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(W, dtype=np.int32), (1, B, W)).copy()
    ring = attn.LayerCache(*(torch.from_numpy(a) for a in (k, v, pos)))
    table = torch.arange(B, dtype=torch.int32)[:, None]
    got = attn.cross_decode_attention(torch.from_numpy(q), ring, 0, table)
    want = jax_decode_attention(
        jnp.asarray(q), JaxLayerCache(*(jnp.asarray(a[0])
                                        for a in (k, v, pos))),
        jnp.int32(2 ** 30), window=None, q_per_kv=G)
    _close(got, want, atol=ATTN_ATOL)
    assert float(got.abs().max()) > 0.1
    trap = ref.paged_decode_attention_ref(
        torch.from_numpy(q[:, 0]).reshape(B, Hkv, G, hd), ring.k[0],
        ring.v[0], table, ring.pos[0],
        torch.full((B,), 2 ** 30, dtype=torch.int32))
    assert float(trap.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# forward, prefill, decode against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_reduced_encdec_vs_jax(variant, kind):
    """The train logits (both routes); the prefill logits at each row's
    last valid token of a right-padded batch, and its self and cross rings
    (k, v, pos: the cross ring the memory's projected K/V at positions
    0..M-1); four decode steps at per-row positions from that prefill (the
    self rings' padded positions masked; the cross rings left as the
    prefill made them), each against JAX's, with the cross rings bit for
    bit unchanged by the steps."""
    cfg, jcfg, params, jp = _setup(variant)
    M = 48
    b = _batch(cfg, 2, 40, M, seed=0)
    if kind == "train":
        with torch.no_grad():
            mine = forward(params, cfg, _t(b), mode="train")
            diff = forward(params, cfg, _t(b), mode="train",
                           differentiable=True)
        want = jax_forward(jp, jcfg, _j(b), mode="train")
        assert mine["text_offset"] == want["text_offset"] == 0
        for out in (mine, diff):
            _close(out["logits"], want["logits"])
        return
    W = 64
    last = np.asarray([39, 17], np.int32)
    with torch.no_grad():
        pre = forward(params, cfg, _t(b), mode="prefill", cache_width=W,
                      last_index=torch.from_numpy(last))
    jpre = jax_forward(jp, jcfg, _j(b), mode="prefill", cache_width=W,
                       last_index=jnp.asarray(last))
    assert set(pre["cache"]) == set(jpre["cache"]) == {"self", "cross"}
    if kind == "prefill":
        _close(pre["logits"], jpre["logits"])
        for name, width in (("self", W), ("cross", M)):
            ring, jring = pre["cache"][name], jpre["cache"][name]
            assert ring.k.shape == (cfg.n_layers, 2, cfg.n_kv_heads, width,
                                    cfg.head_dim)
            _close(ring.k, jring.k)
            _close(ring.v, jring.v)
            assert (ring.pos.numpy() == np.asarray(jring.pos)).all()
        assert (pre["cache"]["cross"].pos.numpy() == np.arange(M)).all()
        return
    cache = mask_padded_positions(pre["cache"], torch.from_numpy(last))
    # the reference masks every ring it is given, the cross rings too (no
    # caller of it reaches an encoder-decoder); the port masks the self
    # rings only, so JAX's is given the self rings alone
    jcache = {"self": jax_mask({"self": jpre["cache"]["self"]},
                               jnp.asarray(last))["self"],
              "cross": jpre["cache"]["cross"]}
    cross0 = [t.clone() for t in cache["cross"]]
    step = last + 1
    rng = np.random.default_rng(1)
    for _ in range(4):
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
    assert all(torch.equal(a, b) for a, b in zip(cache["cross"], cross0))


def test_mask_padded_positions_keeps_the_cross_rings():
    """The self rings lose the positions past each row's last token; the
    cross rings, whose positions are the memory's, keep all of theirs."""
    cfg, _, params, _ = _setup()
    b = _t(_batch(cfg, 2, 20, 30, seed=3))
    with torch.no_grad():
        pre = forward(params, cfg, b, mode="prefill", cache_width=32)
    last = torch.tensor([19, 5], dtype=torch.int32)
    out = mask_padded_positions(pre["cache"], last)
    assert out["cross"] is pre["cache"]["cross"]
    assert int(out["self"].pos[:, 1].max()) == 5
    assert int(out["cross"].pos[:, 1].max()) == 29


def test_decode_parity():
    """``tests/test_models_smoke.py::test_decode_parity`` on the port: one
    decode step after a prefill of x[:-1] (with the same frames) == the
    forward of x at its last position; an empty ``make_decode_cache``
    (cross rings ``dec_enc_len`` wide, every position empty) shaped as
    JAX's."""
    cfg, jcfg, params, _ = _setup()
    B, S = 2, 33
    b = _t(_batch(cfg, B, S, max(S // cfg.enc_len_ratio, 2), seed=4))
    with torch.no_grad():
        full = forward(params, cfg, b, mode="train")["logits"][:, -1]
        pb = {"tokens": b["tokens"][:, :S - 1], "frames": b["frames"]}
        pre = forward(params, cfg, pb, mode="prefill", cache_width=64)
        d = decode_step(params, cfg, pre["cache"],
                        {"tokens": b["tokens"][:, S - 1:]},
                        torch.full((B,), S - 1, dtype=torch.int32))
    _close(d["logits"][:, 0], full, atol=PARITY_ATOL)
    empty = make_decode_cache(params, cfg, B, 64)
    jempty = jax_make_decode_cache(None, jcfg, B, 64)
    assert set(empty) == set(jempty) == {"self", "cross"}
    for name in empty:
        for got, want in zip(empty[name], jempty[name]):
            assert tuple(got.shape) == want.shape
            assert (got.numpy() == np.asarray(want)).all()
    assert empty["cross"].k.shape[3] == cfg.dec_enc_len


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _check_grads(grads, want):
    """Every gradient within ``GRAD_REL`` of its leaf's largest |g|; but
    the cross-attention's key bias, whose exact gradient is zero (no RoPE
    rotates it, so it shifts all of a query's scores by one constant,
    which the softmax ignores), where both packages' values are rounding
    noise: there each within ``ZERO_GRAD_REL`` of the largest |g| of all
    leaves."""
    assert set(grads) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, g in grads.items():
        g = g.numpy()
        assert np.isfinite(g).all(), k
        if k == "layers/cross_attn/bk":
            assert float(np.abs(g).max()) <= ZERO_GRAD_REL * top, k
            assert float(np.abs(want[k]).max()) <= ZERO_GRAD_REL * top, k
            continue
        scale = float(np.abs(want[k]).max())
        assert scale > 0, k
        err = float(np.abs(g - want[k]).max())
        assert err <= GRAD_REL * scale, (k, err, scale)


@pytest.mark.parametrize("variant", ["seamless", "bias-gqa"])
def test_lm_loss_and_grads_vs_jax(variant):
    """``lm_loss`` (frames through the encoder) and every gradient, the
    encoder's and the cross-attention's included, against ``jax.grad``."""
    cfg, jcfg, params, jp = _setup(variant)
    b = _batch(cfg, 2, 40, 24, seed=6)
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
    b = _batch(cfg, 2, 40, 24, seed=7)
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
def test_paged_cache_and_forward_suffix_refuse_as_jax():
    """As JAX's, ``make_paged_decode_cache`` and ``forward_suffix`` refuse
    an encoder-decoder with a ``ValueError``."""
    cfg, jcfg, params, jp = _setup()
    with pytest.raises(ValueError, match="dense/moe/vlm"):
        jax_make_paged(jcfg, 2, 64, num_blocks=9, block_size=16)
    with pytest.raises(ValueError, match="dense/moe/vlm"):
        make_paged_decode_cache(params, cfg, 2, 64, num_blocks=9,
                                block_size=16)
    tok = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="dense/moe/vlm"):
        jax_forward_suffix(jp, jcfg, {"tokens": jnp.asarray(tok)}, {},
                           last_index=jnp.zeros((1,), jnp.int32))
    with pytest.raises(ValueError, match="dense/moe/vlm"):
        forward_suffix(params, cfg, {"tokens": torch.from_numpy(tok)}, {},
                       last_index=torch.zeros((1,), dtype=torch.int32))


def test_checkpoints_both_ways_keep_the_encoder_fields(tmp_path):
    """A JAX encoder-decoder checkpoint (``n_encoder_layers`` and
    ``dec_enc_len`` changed from the config's own, so that a dropped field
    would show) loads in the port with every encoder and frontend field and
    the right shapes, and its logits equal JAX's; the port's save of the
    same weights loads in JAX."""
    jcfg = jax_config(ARCH, reduced=True).replace(
        dtype="float32", n_encoder_layers=3, dec_enc_len=40)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(4))
    jax_ckpt.save(str(tmp_path / "jax"), jp, jcfg)
    cfg, _ = checkpoint.load_config(str(tmp_path / "jax"))
    for f in ENCODER_FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.arch_type == "audio" and cfg.n_encoder_layers == 3
    params = load_checkpoint(str(tmp_path / "jax"), cfg, device="cpu")
    assert params["encoder/attn/wq"].shape[0] == 3
    assert make_decode_cache(params, cfg, 1, 16)["cross"].k.shape[3] == 40
    b = _batch(cfg, 1, 12, 10, seed=9)
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


@pytest.mark.parametrize("arch_type", ["audio", "enc_dec"])
def test_engine_local_backend_and_export_refuse_as_jax(arch_type, tmp_path):
    """The reference's engine refuses an encoder-decoder with
    ``ValueError("engine serves token-only architectures")``; the port's
    engine and ``LocalBackend`` raise the same (the reference's
    ``LocalBackend`` fails later, with a ``KeyError`` on the missing
    frames), and ``export_model`` refuses it by name."""
    cfg, jcfg, params, jp = _setup()
    cfg, jcfg = (c.replace(arch_type=arch_type, frontend=None)
                 for c in (cfg, jcfg))
    msg = "engine serves token-only architectures"
    with pytest.raises(ValueError, match=msg):
        JaxEngine(jp, jcfg, slots=2, max_context=64)
    with pytest.raises(ValueError, match=msg):
        BatchedEngine(params, cfg, slots=2, max_context=64, device="cpu")
    with pytest.raises(ValueError, match=msg):
        LocalBackend(params, cfg, seq_len=64, device="cpu")
    with pytest.raises(NotImplementedError, match="frames"):
        export_model(params, cfg, str(tmp_path / "art"), seq_len=64)
