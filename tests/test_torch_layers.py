"""The port's layers against ``repro.models.layers`` in fp32.

Inputs come from numpy seeds and go through both packages.  Tolerances:
norms, the GELU MLP and the head agree to fp32 rounding (atol 1e-5); the
age encoding is the exception, measured: at age 85 the top frequency's angle
is ~8.5e4 rad, XLA's fp32 ``exp`` is one ulp off at a few entries of the
frequency table, and one ulp of a frequency moves such an angle by up to
~5e-3 rad, so the encodings agree to atol 1e-2 (measured: < 6e-3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as jl
from repro_torch.models import layers as tl

torch.set_num_threads(2)

CFG = jax_config("delphi-2m").replace(dtype="float32")


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norm_matches_jax(kind):
    rng = _rng(1)
    x = (rng.standard_normal((3, 7, 120)) * 4 + 1).astype(np.float32)
    scale = rng.standard_normal(120).astype(np.float32)
    bias = rng.standard_normal(120).astype(np.float32)
    p = {"scale": jnp.asarray(scale)}
    if kind == "layernorm":
        p["bias"] = jnp.asarray(bias)
    want = np.asarray(jl.apply_norm(p, jnp.asarray(x), CFG))
    got = tl.apply_norm(torch.from_numpy(x), torch.from_numpy(scale),
                        torch.from_numpy(bias) if kind == "layernorm"
                        else None)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_norm_keeps_bf16_activations():
    x = torch.randn(2, 5, 120).to(torch.bfloat16)
    y = tl.apply_norm(x, torch.ones(120), torch.zeros(120))
    assert y.dtype == torch.bfloat16


def test_gelu_mlp_matches_jax_tanh_gelu():
    rng = _rng(2)
    x = rng.standard_normal((2, 9, 120)).astype(np.float32)
    w_fc = (rng.standard_normal((120, 480)) * 0.2).astype(np.float32)
    b_fc = rng.standard_normal(480).astype(np.float32)
    w_proj = (rng.standard_normal((480, 120)) * 0.1).astype(np.float32)
    b_proj = rng.standard_normal(120).astype(np.float32)
    want = np.asarray(jl.apply_mlp(
        {"w_fc": jnp.asarray(w_fc), "b_fc": jnp.asarray(b_fc),
         "w_proj": jnp.asarray(w_proj), "b_proj": jnp.asarray(b_proj)},
        jnp.asarray(x), CFG))
    got = tl.apply_mlp(*(torch.from_numpy(a) for a in
                         (x, w_fc, b_fc, w_proj, b_proj)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the exact-erf GELU would not agree: the tanh form is the contract
    exact = torch.nn.functional.gelu(torch.from_numpy(x @ w_fc + b_fc))
    tanh = torch.nn.functional.gelu(torch.from_numpy(x @ w_fc + b_fc),
                                    approximate="tanh")
    assert float((exact - tanh).abs().max()) > 1e-4


@pytest.mark.parametrize("d_model", [120, 256, 7])
def test_age_encoding_matches_jax(d_model):
    rng = _rng(3)
    ages = np.concatenate([np.zeros((1,)), rng.uniform(0, 85, 199),
                           [85.0]]).astype(np.float32).reshape(1, -1)
    want = np.asarray(jl.age_encoding(jnp.asarray(ages), d_model))
    got = tl.age_encoding(torch.from_numpy(ages), d_model).numpy()
    assert got.shape == want.shape == (1, 201, d_model)
    np.testing.assert_allclose(got, want, atol=1e-2)
    # at young ages (angles <= ~1e4 rad) the agreement is much closer
    young = ages[0] < 10
    np.testing.assert_allclose(got[0, young], want[0, young], atol=2e-3)


def test_age_frequency_table_within_one_ulp_of_jax():
    for half in (60, 128):
        log_inc = jnp.log(200.0 / 1e-3) / (half - 1)
        want = np.asarray(1000.0 * jnp.exp(-log_inc * jnp.arange(
            half, dtype=jnp.float32)))
        got = tl._inv_scales(half, 1e-3, 200.0, "cpu").numpy()
        ulps = np.abs(got.view(np.int32) - want.view(np.int32))
        assert ulps.max() <= 1, ulps


def test_logits_head_matches_jax():
    rng = _rng(4)
    h = rng.standard_normal((2, 3, 120)).astype(np.float32)
    emb = (rng.standard_normal((1289, 120)) * 0.02).astype(np.float32)
    bias = np.full((1289,), -8.0, np.float32)
    want = np.asarray(jl.logits_head(
        {"embed": jnp.asarray(emb), "out_bias": jnp.asarray(bias)},
        jnp.asarray(h), CFG))
    got = tl.logits_head(torch.from_numpy(emb), torch.from_numpy(h),
                         torch.from_numpy(bias))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_logits_head_bf16_product_then_fp32_bias():
    h = torch.randn(2, 1, 120).to(torch.bfloat16)
    emb = torch.randn(1289, 120) * 0.02
    bias = torch.full((1289,), -8.0)
    got = tl.logits_head(emb, h, bias)
    want = (h @ emb.to(torch.bfloat16).T).float() + bias
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
