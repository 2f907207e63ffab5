"""The port's Mamba2 path against the JAX package, in fp32 on the CPU.

The same numpy-seeded inputs go through both packages:

* the ``ssd_intra`` plain version (``kernels.ops`` on CPU tensors) against
  the JAX Pallas kernel in interpret mode and its oracle, at
  ``tests/test_kernels.py``'s ``SSD_CASES`` (tolerance atol 1e-4 in fp32 and
  0.15 in bf16, as there);
* ``ssd_chunked`` against the JAX ``ssd_chunked`` and the sequential
  ``ssd_ref`` at chunks 8/16/64 and across an ``h0`` continuation (atol
  1e-4, as ``tests/test_ssm.py``);
* one Mamba2 block's prefill state and decode step against the JAX block on
  reduced ``mamba2-780m`` (atol 1e-4);
* the model's prefill and step-by-step decode logits against the JAX model
  on reduced ``mamba2-780m`` and on a full-width variant (d_model 1536,
  N 128, P 64, chunk 128; 2 layers, vocab 512, S ~ 300).  Over three
  seeds the logits agreed to < 4.2e-6 (reduced) and < 5.4e-6 (full width)
  on the CPU; the tests allow 1e-4, ``tests/test_ssm.py``'s tolerance;
* the weight bridge: keys and shapes of the full ``mamba2-780m`` equal the
  JAX ``init_params`` pytree's, and the reduced one round-trips exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import param_count as jax_param_count
from repro.models import ssm as jssm
from repro.train import checkpoint as jax_checkpoint
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import (decode_step, forward, from_jax_flat,
                                init_params, make_decode_cache, param_count,
                                to_flat_numpy)
from repro_torch.models import ssm as tssm
from repro_torch.models.params import param_shapes

torch.set_num_threads(2)

LOGITS_ATOL = 1e-4


def jax_params(flat):
    out = {}
    for key, arr in flat.items():
        node = out
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arr)
    return out


def _np(x):
    return np.asarray(x, dtype=np.float32)


# ---------------------------------------------------------------------------
# (a) ssd_intra
# ---------------------------------------------------------------------------
SSD_CASES = [
    # (BH, C, Q, P, N, dtype): tests/test_kernels.py's SSD_CASES
    (1, 1, 16, 8, 8, "float32"),
    (4, 3, 32, 16, 32, "float32"),
    (2, 2, 128, 64, 128, "float32"),     # production tile (mamba2-780m)
    (2, 2, 64, 32, 64, "bfloat16"),
]


@pytest.mark.parametrize("BH,C,Q,P,N,dtype", SSD_CASES)
def test_ssd_intra_vs_jax_kernel_and_oracle(BH, C, Q, P, N, dtype):
    rng = np.random.default_rng(Q * 7 + P)
    xdt = rng.standard_normal((BH, C, Q, P)).astype(np.float32)
    Bm = rng.standard_normal((BH, C, Q, N)).astype(np.float32)
    Cm = rng.standard_normal((BH, C, Q, N)).astype(np.float32)
    cum = -np.cumsum(rng.uniform(0, 0.2, (BH, C, Q)), -1).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    y, st = ops.ssd_intra(*(torch.from_numpy(a).to(tdt)
                            for a in (xdt, Bm, Cm)), torch.from_numpy(cum))
    assert y.dtype == st.dtype == torch.float32
    assert y.shape == (BH, C, Q, P) and st.shape == (BH, C, N, P)
    jy, jst = jops.ssd_intra(*(jnp.asarray(a, jdt) for a in (xdt, Bm, Cm)),
                             jnp.asarray(cum))
    atol = 1e-4 if dtype == "float32" else 0.15
    np.testing.assert_allclose(y.numpy(), _np(jy), atol=atol)
    np.testing.assert_allclose(st.numpy(), _np(jst), atol=atol)
    for b in range(BH):
        for c in range(C):
            yr, sr = jref.ssd_intra_ref(
                *(jnp.asarray(a[b, c], jdt).astype(jnp.float32)
                  for a in (xdt, Bm, Cm)), jnp.asarray(cum[b, c]))
            np.testing.assert_allclose(y[b, c].numpy(), _np(yr), atol=atol)
            np.testing.assert_allclose(st[b, c].numpy(), _np(sr), atol=atol)


def test_ssd_intra_heads_shares_one_bc_tile_among_heads():
    """The model's layout: B/C broadcast over the heads by a 0 stride give
    the same tiles as H separate copies, and H = 1 is ``ssd_intra``."""
    rng = np.random.default_rng(5)
    b, C, Q, H, P, N = 2, 3, 32, 4, 16, 8
    xdt = torch.from_numpy(rng.standard_normal((b, C, Q, H, P)).astype(np.float32))
    Bm = torch.from_numpy(rng.standard_normal((b, C, Q, 1, N)).astype(np.float32))
    Cm = torch.from_numpy(rng.standard_normal((b, C, Q, 1, N)).astype(np.float32))
    cum = torch.from_numpy(
        -np.cumsum(rng.uniform(0, 0.2, (b, C, Q, H)), 2).astype(np.float32))
    y, st = ops.ssd_intra_heads(xdt, Bm.expand(b, C, Q, H, N),
                                Cm.expand(b, C, Q, H, N), cum)
    assert y.shape == (b, C, Q, H, P) and st.shape == (b, C, H, N, P)
    for h in range(H):
        yh, sh = ops.ssd_intra(xdt[:, :, :, h], Bm[:, :, :, 0], Cm[:, :, :, 0],
                               cum[..., h])
        torch.testing.assert_close(y[:, :, :, h], yh, atol=1e-6, rtol=0)
        torch.testing.assert_close(st[:, :, h], sh, atol=1e-6, rtol=0)


def test_ssd_intra_plain_version_has_no_nan_at_steep_decay():
    """exp(cum_i - cum_j) is taken only for j <= i: a steep decay overflows
    above the diagonal, and inf * 0 would be NaN."""
    Q = 32
    cum = -torch.arange(Q, dtype=torch.float32)[None, None] * 10.0
    x = torch.ones((1, 1, Q, 4))
    y, st = ref.ssd_intra_ref(x, torch.ones((1, 1, Q, 2)),
                              torch.ones((1, 1, Q, 2)), cum)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())


# ---------------------------------------------------------------------------
# (b) ssd_chunked
# ---------------------------------------------------------------------------
def _ssd_inputs(seed, B=2, S=64, H=4, P=8, N=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (B, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, (H,)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_vs_jax_and_sequential_oracle(chunk):
    arrs = _ssd_inputs(chunk)
    y, h = tssm.ssd_chunked(*(torch.from_numpy(a) for a in arrs), chunk)
    jy, jh = jssm.ssd_chunked(*(jnp.asarray(a) for a in arrs), chunk)
    ry, rh = jref.ssd_ref(*(jnp.asarray(a) for a in arrs))
    for want_y, want_h in ((jy, jh), (ry, rh)):
        np.testing.assert_allclose(y.numpy(), _np(want_y), atol=1e-4)
        np.testing.assert_allclose(h.numpy(), _np(want_h), atol=1e-4)


def test_ssd_chunked_initial_state_continuation():
    """[first half] then [second half | its state] == the full run, and
    the continuation matches JAX's."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _ssd_inputs(1))
    y_full, h_full = tssm.ssd_chunked(x, dt, A, Bm, Cm, 16)
    y1, h1 = tssm.ssd_chunked(x[:, :32], dt[:, :32], A, Bm[:, :32],
                              Cm[:, :32], 16)
    y2, h2 = tssm.ssd_chunked(x[:, 32:], dt[:, 32:], A, Bm[:, 32:],
                              Cm[:, 32:], 16, h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(h2, h_full, atol=1e-4, rtol=0)
    jy2, jh2 = jssm.ssd_chunked(*(jnp.asarray(t[:, 32:].numpy())
                                  for t in (x, dt)), jnp.asarray(A.numpy()),
                                *(jnp.asarray(t[:, 32:].numpy())
                                  for t in (Bm, Cm)), 16,
                                h0=jnp.asarray(h1.numpy()))
    np.testing.assert_allclose(y2.numpy(), _np(jy2), atol=1e-4)
    np.testing.assert_allclose(h2.numpy(), _np(jh2), atol=1e-4)


# ---------------------------------------------------------------------------
# (c) one Mamba2 block: prefill state + decode step
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _setup(full_width: bool):
    if full_width:
        cfg = get_config("mamba2-780m").replace(
            n_layers=2, vocab_size=512, dtype="float32")
        jcfg = jax_config("mamba2-780m").replace(
            n_layers=2, vocab_size=512, dtype="float32")
    else:
        cfg = get_config("mamba2-780m", reduced=True).replace(dtype="float32")
        jcfg = jax_config("mamba2-780m", reduced=True).replace(
            dtype="float32")
    params = init_params(cfg, seed=1, device="cpu")
    return cfg, jcfg, params, jax_params(to_flat_numpy(params))


@pytest.mark.parametrize("S", [21, 77])     # one chunk / three chunks of 32
def test_ssm_block_prefill_state_and_decode_vs_jax(S):
    cfg, jcfg, params, jp = _setup(False)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S + 1, cfg.d_model)).astype(np.float32)
    p = tssm.layer_params(params, 0)
    jlp = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["ssm"])
    xt = torch.from_numpy(x)
    y_pre, (h, conv) = tssm.ssm_forward(p, xt[:, :S], cfg, return_state=True)
    jy_pre, jc = jssm.ssm_forward(jlp, jnp.asarray(x[:, :S]), jcfg,
                                  return_state=True)
    np.testing.assert_allclose(y_pre.numpy(), _np(jy_pre), atol=1e-4)
    np.testing.assert_allclose(h.numpy(), _np(jc.h), atol=1e-4)
    np.testing.assert_allclose(conv.numpy(), _np(jc.conv), atol=1e-4)
    y_dec, h2, conv2 = tssm.ssm_decode_step(p, xt[:, S:], h, conv, cfg)
    jy_dec, jc2 = jssm.ssm_decode_step(jlp, jnp.asarray(x[:, S:]), jc, jcfg)
    np.testing.assert_allclose(y_dec.numpy(), _np(jy_dec), atol=1e-4)
    np.testing.assert_allclose(h2.numpy(), _np(jc2.h), atol=1e-4)
    np.testing.assert_allclose(conv2.numpy(), _np(jc2.conv), atol=1e-4)
    # and the port's own decode step continues its full-sequence forward
    y_full = tssm.ssm_forward(p, xt, cfg)
    torch.testing.assert_close(y_dec, y_full[:, S:], atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# (d) the model: prefill and decode logits
# ---------------------------------------------------------------------------
CASES = [pytest.param(False, 45, id="mamba2-780m-reduced"),
         pytest.param(True, 300, id="mamba2-780m-full-width")]


@pytest.mark.parametrize("full_width,S", CASES)
def test_model_prefill_and_decode_vs_jax(full_width, S):
    cfg, jcfg, params, jp = _setup(full_width)
    B, steps = 2, 3
    rng = np.random.default_rng(S)
    toks = rng.integers(0, cfg.vocab_size, (B, S + steps)).astype(np.int32)
    out = forward(params, cfg, {"tokens": torch.from_numpy(toks[:, :S])},
                  mode="prefill")
    jout = jax.jit(lambda t: jax_forward(jp, jcfg, {"tokens": t},
                                         mode="prefill"))(
        jnp.asarray(toks[:, :S]))
    assert out["logits"].shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(out["logits"].numpy(), _np(jout["logits"]),
                               atol=LOGITS_ATOL)
    sc, jsc = out["cache"]["ssm"], jout["cache"]["ssm"]
    assert sc.h.shape == (cfg.n_layers, B, cfg.ssm_n_heads, cfg.ssm_state,
                          cfg.ssm_head_dim) and sc.h.dtype == torch.float32
    np.testing.assert_allclose(sc.h.numpy(), _np(jsc.h), atol=1e-3)
    cache, jcache = out["cache"], jout["cache"]
    jdec = jax.jit(lambda c, t, s: jax_decode_step(jp, jcfg, c,
                                                   {"tokens": t}, s))
    for i in range(steps):
        t = toks[:, S + i:S + i + 1]
        d = decode_step(params, cfg, cache, {"tokens": torch.from_numpy(t)},
                        S + i)
        jd = jdec(jcache, jnp.asarray(t), jnp.int32(S + i))
        jcache = jd["cache"]
        np.testing.assert_allclose(d["logits"].numpy(), _np(jd["logits"]),
                                   atol=LOGITS_ATOL, err_msg=f"step {i}")
    # decode continues the prefill exactly as the train-mode forward does
    full = forward(params, cfg, {"tokens": torch.from_numpy(toks)})["logits"]
    torch.testing.assert_close(d["logits"][:, 0], full[:, -1], atol=1e-4,
                               rtol=0)


def test_make_decode_cache_and_mask_pass_ssm_state_through():
    cfg = get_config("mamba2-780m", reduced=True)
    params = init_params(cfg, seed=0, device="cpu")
    sc = make_decode_cache(params, cfg, 3, 1 << 20)["ssm"]
    assert sc.h.shape == (2, 3, cfg.ssm_n_heads, 16, 32)
    assert sc.h.dtype == torch.float32 and sc.conv.dtype == torch.bfloat16
    assert sc.conv.shape == (2, 3, 4, cfg.d_inner + 32)
    from repro_torch.models import mask_padded_positions
    masked = mask_padded_positions({"ssm": sc}, torch.tensor([0, 1, 2]))
    assert masked["ssm"] is sc


# ---------------------------------------------------------------------------
# (e) the weight bridge
# ---------------------------------------------------------------------------
def test_param_shapes_equal_jax_init_params_at_full_size():
    cfg = jax_config("mamba2-780m")
    shapes = jax.eval_shape(functools.partial(jax_init_params, cfg),
                            jax.random.PRNGKey(0))
    # the keys train/checkpoint.py's _flatten writes, on the shape pytree
    want = {"/".join(str(p.key) for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert param_shapes(get_config("mamba2-780m")) == want
    assert want["layers/ssm/in_proj"] == (48, 1536, 2 * 3072 + 2 * 128 + 48)


def test_bridge_round_trips_reduced_jax_params():
    jcfg = jax_config("mamba2-780m", reduced=True)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    flat = jax_checkpoint._flatten(jp)
    cfg = get_config("mamba2-780m", reduced=True)
    params = from_jax_flat(flat, cfg, device="cpu")
    back = to_flat_numpy(params)
    assert set(back) == set(flat)
    assert all(np.array_equal(back[k], np.asarray(flat[k])) for k in flat)
    assert param_count(params) == jax_param_count(jp)
    # the port's own init: same keys and shapes, the deterministic leaves
    # equal to JAX's, the random ones at JAX's scales
    mine = init_params(cfg, seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: np.asarray(v).shape for k, v in flat.items()}
    for key in ("layers/ssm/A_log", "layers/ssm/dt_bias", "layers/ssm/D",
                "layers/ssm/norm_scale", "layers/ssm/conv_b",
                "layers/norm/scale", "final_norm/scale"):
        np.testing.assert_allclose(mine[key].numpy(), np.asarray(flat[key]),
                                   rtol=1e-6, err_msg=key)
    d, di = cfg.d_model, cfg.d_inner
    for key, want in [("layers/ssm/in_proj", d ** -0.5),
                      ("layers/ssm/out_proj", di ** -0.5),
                      ("layers/ssm/conv_w", cfg.ssm_conv ** -0.5),
                      ("embed/lm_head", d ** -0.5), ("embed/embed", 0.02)]:
        std = float(mine[key].std())
        assert abs(std - want) < 0.05 * want, (key, std, want)
