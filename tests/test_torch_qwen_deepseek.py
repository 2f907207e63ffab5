"""Qwen2.5-32B and DeepSeek-7B on one card: what the CPU can hold of it.

* ``launch.serve.init_weights``: on a CUDA device every generic dense LM's
  weights are made on the device in their use dtypes
  (``init_params_on_device``; Qwen2.5-32B's fp32 tree is 131 GB, its bf16
  one 65.5 GB), as every MoE config's are anywhere; Delphi, Mamba2 and
  Zamba2 keep ``init_params``, and so does every dense LM on the CPU, whose
  draws the CPU tests hold against JAX.  Checked with the two initialisers
  replaced by recorders, so nothing is allocated; the CLI's CPU route
  serves ``init_params``' tensors bit for bit.
* ``core.parity.layered_prefill_logits``, the fp32 model's prefill logits
  computed one layer at a time on weights held in bf16 (the card's
  full-depth reference for a model whose fp32 tree does not fit it),
  against the port's fp32 ``forward(mode="prefill")`` on the same weights
  upcast (allowed 1e-5; 0 measured on these inputs: the same blocks in
  the same order), and against JAX's ``forward`` on the bf16-rounded
  weights, carried into the port by ``from_jax_flat`` (allowed 5e-5, as
  ``tests/test_torch_dense.py``'s reduced archs; measured within 5e-6).
* ``core.parity.check_lm_steps``: ``check_lm_trajectories``' margin rule on
  rows a caller computed itself (the long prompt's prefills on the card).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import forward as jax_forward
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core import parity as par
from repro_torch.launch import serve as launch
from repro_torch.models import (cast_params, forward, from_jax_flat,
                                init_params, to_flat_numpy)

torch.set_num_threads(2)

ARCHS = ["qwen2.5-32b", "deepseek-7b"]
SELF_ATOL = 1e-5
JAX_ATOL = 5e-5
# where launch.serve makes each architecture's weights: (on a CUDA device,
# on the CPU)
ON_DEVICE, HOST = "init_params_on_device", "init_params"
ROUTES = {
    "delphi-2m": (HOST, HOST), "delphi-100m": (HOST, HOST),
    "tinyllama-1.1b": (ON_DEVICE, HOST), "h2o-danube-1.8b": (ON_DEVICE, HOST),
    "qwen2.5-32b": (ON_DEVICE, HOST), "deepseek-7b": (ON_DEVICE, HOST),
    "olmoe-1b-7b": (ON_DEVICE, ON_DEVICE),
    "qwen2-moe-a2.7b": (ON_DEVICE, ON_DEVICE),
    "mamba2-780m": (HOST, HOST), "zamba2-1.2b": (HOST, HOST),
    "internvl2-26b": (HOST, HOST), "seamless-m4t-large-v2": (HOST, HOST),
}


def test_routes_cover_the_registry():
    assert sorted(ROUTES) == sorted(ALL_ARCHS)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("arch", sorted(ROUTES))
def test_init_weights_picks_the_initialiser_by_family_and_device(
        arch, device, monkeypatch):
    calls = []
    for name in (ON_DEVICE, HOST):
        monkeypatch.setattr(launch, name,
                            lambda cfg, seed, dev, _n=name: calls.append(
                                (_n, cfg.name, seed, dev)) or {})
    dev = torch.device(device)
    cfg = get_config(arch)
    launch.init_weights(cfg, 5, dev)
    want = ROUTES[arch][0 if device == "cuda" else 1]
    assert calls == [(want, cfg.name, 5, dev)]


def test_cli_on_the_cpu_serves_init_params_weights(monkeypatch):
    """The CPU route is the one the CLI tests hold against JAX: reduced
    Qwen2.5-32B in fp32, ``init_params(seed)``'s tensors bit for bit."""
    monkeypatch.setattr(launch, "get_config",
                        lambda name: get_config(name, reduced=True))
    out = launch.serve(launch.parse_args(
        ["--arch", "qwen2.5-32b", "--device", "cpu", "--requests", "2",
         "--slots", "2", "--max-new", "2", "--max-context", "128"]))
    eng = out["engine"]
    want = init_params(get_config("qwen2.5-32b", reduced=True).replace(
        dtype="float32"), 0, torch.device("cpu"))
    assert eng.cfg.dtype == "float32" and len(out["done"]) == 2
    assert sorted(eng.params) == sorted(want)
    for k, v in want.items():
        assert eng.params[k].dtype == torch.float32
        assert torch.equal(eng.params[k], v), k


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """Reduced ``arch`` and a flat fp32 checkpoint of its seeded draws
    (Qwen2.5's QKV biases drawn at random, as test_torch_dense.py's),
    every value rounded to bf16, so that the weights held in bf16 and
    their fp32 upcast are the same numbers."""
    cfg = get_config(arch, reduced=True)
    flat = to_flat_numpy(init_params(cfg.replace(dtype="float32"), seed=1,
                                     device="cpu"))
    rng = np.random.default_rng(7)
    for k in ("layers/attn/bq", "layers/attn/bk", "layers/attn/bv"):
        if k in flat:
            flat[k] = (0.5 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    flat = {k: torch.from_numpy(np.ascontiguousarray(v)).bfloat16().float()
            .numpy() for k, v in flat.items()}
    return cfg, flat


def _prompts(cfg, B=3, S=90, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, cfg.vocab_size, (B, S)).astype(np.int32)
    last = np.asarray([S - 1, 40, 7], np.int32)[:B]
    return toks, last


@pytest.mark.parametrize("arch", ARCHS)
def test_layered_reference_equals_the_fp32_prefill(arch):
    cfg, flat = _weights(arch)
    w16 = from_jax_flat(flat, cfg, "cpu")
    assert w16["layers/mlp/w_up"].dtype == torch.bfloat16
    assert cast_params(w16, cfg)["layers/mlp/w_up"] is w16["layers/mlp/w_up"]
    toks, last = _prompts(cfg)
    t, li = torch.from_numpy(toks), torch.from_numpy(last)
    got = par.layered_prefill_logits(w16, cfg, t, li)
    c32 = cfg.replace(dtype="float32")
    with torch.no_grad():
        want = forward({k: v.float() for k, v in w16.items()}, c32,
                       {"tokens": t}, mode="prefill", last_index=li)["logits"]
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=SELF_ATOL,
                               rtol=0)
    # at the last position when no index is given
    full = par.layered_prefill_logits(w16, cfg, t)
    np.testing.assert_allclose(full[0].numpy(), got[0].numpy(),
                               atol=SELF_ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_layered_reference_against_jax(arch):
    from tests.test_torch_dense import jax_params
    cfg, flat = _weights(arch)
    w16 = from_jax_flat(flat, cfg, "cpu")
    toks, last = _prompts(cfg, seed=1)
    got = par.layered_prefill_logits(w16, cfg, torch.from_numpy(toks),
                                     torch.from_numpy(last))
    jcfg = jax_config(arch, reduced=True).replace(dtype="float32")
    want = jax_forward(jax_params(flat), jcfg, {"tokens": jnp.asarray(toks)},
                       mode="prefill", last_index=jnp.asarray(last))
    np.testing.assert_allclose(got.numpy(), np.asarray(want["logits"]),
                               atol=JAX_ATOL, rtol=0)


def test_layered_reference_refuses_other_families():
    with pytest.raises(ValueError, match="generic dense LM"):
        par.layered_prefill_logits({}, get_config("delphi-2m", reduced=True),
                                   torch.zeros((1, 4), dtype=torch.int64))


def test_check_lm_steps_is_check_lm_trajectories_rule():
    """The rows of ``check_lm_trajectories`` handed to ``check_lm_steps``
    give the same verdict; a token off by more than the margin raises."""
    cfg, flat = _weights("deepseek-7b")
    params = from_jax_flat(flat, cfg.replace(dtype="float32"), "cpu")
    c32 = cfg.replace(dtype="float32")
    rng = np.random.default_rng(3)
    prompt = rng.integers(3, cfg.vocab_size, 20).astype(np.int32)
    u = rng.random((4, cfg.vocab_size), dtype=np.float32)
    fn = par.port_logits_fn(params, c32)
    out, seq = [], list(prompt)
    for i in range(4):
        lg = fn(np.asarray([seq]), np.zeros((1, len(seq)), np.float32))
        tok = int(np.argmax(par.gumbel_scores(lg[0, -1], u[i])))
        out.append(tok)
        seq.append(tok)
    held = par.check_lm_trajectories([prompt], [out], [u], fn,
                                     margin_tol=1e-3)
    full = fn(np.asarray([seq[:-1]]), np.zeros((1, len(seq) - 1),
                                               np.float32))[0]
    rows = [full[len(prompt) - 1:]]
    assert par.check_lm_steps(rows, [out], [u], margin_tol=1e-3) == held
    assert held["steps"] == 4 and not held["near_ties"]
    scores = par.gumbel_scores(rows[0][1], u[1])
    worst = int(np.argmin(scores))
    with pytest.raises(AssertionError, match="step 1"):
        par.check_lm_steps(rows, [[out[0], worst]], [u], margin_tol=1e-3)
