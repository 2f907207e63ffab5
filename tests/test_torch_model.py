"""The port's model against ``repro.models`` in fp32.

One set of weights (the port's numpy-seeded ``init_params``, handed to the
JAX model through the flat checkpoint layout) and numpy-seeded batches go
through both packages: prefill logits at ``last_index``, the ring cache
after ``mask_padded_positions``, then step-by-step ``decode_step`` logits at
per-row positions, on reduced Delphi and on full-width Delphi-2M.

Tolerances are measured, not assumed (see the age-encoding note in
``test_torch_layers.py``): over four seeds of these batches (ages 30-84)
the logits agreed to < 8e-4 and the cached keys to < 3.2e-3 on both
configurations (measured maxima on the CPU); the tests allow 2e-3 and 1e-2.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import sampler as jsampler
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import mask_padded_positions as jax_mask
from repro_torch.configs import get_config
from repro_torch.core import generate_trajectories
from repro_torch.core.parity import check_trajectories, compare_runs
from repro_torch.models import (decode_step, forward, init_params,
                                make_decode_cache, mask_padded_positions,
                                to_flat_numpy)

torch.set_num_threads(2)

CASES = [pytest.param(True, id="delphi-2m-reduced"),
         pytest.param(False, id="delphi-2m")]
LOGITS_ATOL = 2e-3
KV_ATOL = 1e-2


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


@functools.lru_cache(maxsize=None)
def _setup(reduced):
    cfg = get_config("delphi-2m", reduced=reduced).replace(dtype="float32")
    jcfg = jax_config("delphi-2m", reduced=reduced).replace(dtype="float32")
    params = init_params(cfg, seed=1, device="cpu")
    return cfg, jcfg, params, jax_params(to_flat_numpy(params))


def _batch(rng, cfg, B, S):
    toks = rng.integers(3, cfg.vocab_size, (B, S)).astype(np.int32)
    ages = np.sort(rng.uniform(30, 84, (B, S)), axis=1).astype(np.float32)
    return toks, ages


@pytest.mark.parametrize("reduced", CASES)
def test_prefill_then_decode_logits_vs_jax(reduced):
    atol = LOGITS_ATOL
    cfg, jcfg, params, jp = _setup(reduced)
    rng = np.random.default_rng(5)
    B, S, W = 3, 20, 32
    toks, ages = _batch(rng, cfg, B, S)
    last = np.array([S - 1, 9, 14], np.int32)
    jfwd = jax.jit(functools.partial(jax_forward, cfg=jcfg, mode="prefill",
                                     cache_width=W))
    jo = jfwd(jp, batch={"tokens": jnp.asarray(toks),
                         "ages": jnp.asarray(ages)},
              last_index=jnp.asarray(last))
    with torch.no_grad():
        to = forward(params, cfg, {"tokens": torch.from_numpy(toks),
                                   "ages": torch.from_numpy(ages)},
                     mode="prefill", cache_width=W,
                     last_index=torch.from_numpy(last))
    assert to["logits"].shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(to["logits"].numpy(),
                               np.asarray(jo["logits"]), atol=atol)
    jc = jax_mask(jo["cache"], jnp.asarray(last))
    tc = mask_padded_positions(to["cache"], torch.from_numpy(last))
    np.testing.assert_array_equal(tc["self"].pos.numpy(),
                                  np.asarray(jc["self"].pos))
    np.testing.assert_allclose(tc["self"].k.numpy(),
                               np.asarray(jc["self"].k), atol=KV_ATOL)

    jdec = jax.jit(functools.partial(jax_decode_step, cfg=jcfg))
    age = ages[np.arange(B), last]
    step = last + 1                   # each row decodes at its own depth
    for i in range(4):
        tok = rng.integers(3, cfg.vocab_size, (B, 1)).astype(np.int32)
        age = (age + rng.uniform(0.01, 2.0, B)).astype(np.float32)
        jd = jdec(jp, cache=jc, batch={"tokens": jnp.asarray(tok),
                                       "ages": jnp.asarray(age[:, None])},
                  step=jnp.asarray(step))
        with torch.no_grad():
            td = decode_step(params, cfg, tc,
                             {"tokens": torch.from_numpy(tok),
                              "ages": torch.from_numpy(age[:, None])},
                             torch.from_numpy(step))
        np.testing.assert_allclose(td["logits"].numpy(),
                                   np.asarray(jd["logits"]), atol=atol,
                                   err_msg=f"decode step {i}")
        jc, tc = jd["cache"], td["cache"]
        np.testing.assert_array_equal(tc["self"].pos.numpy(),
                                      np.asarray(jc["self"].pos))
        step = step + 1


def test_train_mode_logits_vs_jax():
    cfg, jcfg, params, jp = _setup(True)
    toks, ages = _batch(np.random.default_rng(6), cfg, 2, 24)
    want = jax.jit(functools.partial(jax_forward, cfg=jcfg))(
        jp, batch={"tokens": jnp.asarray(toks), "ages": jnp.asarray(ages)})
    with torch.no_grad():
        got = forward(params, cfg, {"tokens": torch.from_numpy(toks),
                                    "ages": torch.from_numpy(ages)})
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=LOGITS_ATOL)


def test_generate_trajectories_vs_jax():
    """The straight-line oracle with injected uniforms: each of its steps is
    held against the JAX model on the trajectory's own prefix (margin and
    age tolerance 2e-3: the port-vs-JAX waiting-time disagreement measured
    on this configuration is < 6e-4), and it runs the same course as the
    JAX ``generate_trajectories`` up to the first divergence."""
    cfg, jcfg, params, jp = _setup(True)
    rng = np.random.default_rng(8)
    B, S, max_new = 3, 6, 8
    toks, ages = _batch(rng, cfg, B, S)
    ages = (ages * 0.1 + 60).astype(np.float32)    # ~20 years before max age
    u = rng.random((B, max_new, cfg.vocab_size), dtype=np.float32)
    with torch.no_grad():
        out = generate_trajectories(params, cfg, torch.from_numpy(toks),
                                    torch.from_numpy(ages), max_new=max_new,
                                    uniforms=torch.from_numpy(u))
    jout = jsampler.generate_trajectories(
        jp, jcfg, jnp.asarray(toks), jnp.asarray(ages), jax.random.PRNGKey(0),
        max_new=max_new, uniforms=jnp.asarray(u))

    def trajs(o):
        n = np.asarray(o["n_generated"])
        t, a = np.asarray(o["tokens"]), np.asarray(o["ages"])
        return [(t[b, S:S + n[b]].tolist(), a[b, S:S + n[b]].tolist())
                for b in range(B)]

    mine = trajs({k: v.numpy() for k, v in out.items()})
    assert sum(len(t) for t, _ in mine) > 0
    jf = jax.jit(lambda t, a: jax_forward(jp, jcfg, {"tokens": t,
                                                    "ages": a})["logits"])
    held = check_trajectories(
        [(toks[b], ages[b]) for b in range(B)], mine, list(u),
        lambda t, a: np.asarray(jf(jnp.asarray(t, jnp.int32),
                                   jnp.asarray(a))),
        margin_tol=2e-3, age_rtol=2e-3, max_age=cfg.max_age,
        death_token=cfg.death_token, max_context=S + max_new + 1)
    assert held["steps"] == sum(len(t) for t, _ in mine)
    free = compare_runs(trajs(jout), mine, age_rtol=0.25)
    assert free["compared"] >= B       # at least every first event agrees


def test_make_decode_cache_shapes():
    cfg = get_config("delphi-2m")
    params = init_params(cfg, seed=0, device="cpu")
    lc = make_decode_cache(params, cfg, 4, 256)["self"]
    assert lc.k.shape == lc.v.shape == (12, 4, 12, 256, 10)
    assert lc.k.dtype == torch.bfloat16
    assert lc.pos.shape == (12, 4, 256) and int(lc.pos.max()) == -1


@pytest.mark.parametrize("change", [
    dict(age_encoding=False), dict(n_kv_heads=2), dict(activation="swiglu"),
    dict(norm="rmsnorm"), dict(sliding_window=64),
    dict(arch_type="moe", n_experts=4, top_k=2, moe_d_ff=64),
    dict(arch_type="hybrid", attn_every=1, ssm_state=16),
])
def test_configs_outside_the_slice_raise(change):
    """The knobs that this test once held refused (RoPE, GQA, SwiGLU,
    RMSNorm, a sliding window, the MoE stack: 4 experts, top-2, in place
    of the MLP, and the hybrid stack: Mamba2 layers with the shared
    attention block before each) are served: on reduced Delphi with that
    one knob changed, the prefill logits at the last position of an
    80-event history (longer than the window of 64) match the JAX
    package's within ``LOGITS_ATOL``.  An MoE stack with no experts, which
    JAX's config lets through, is refused where it is made."""
    if change.get("arch_type") == "moe":
        with pytest.raises(ValueError, match="n_experts"):
            get_config("delphi-2m", reduced=True).replace(arch_type="moe")
    cfg = get_config("delphi-2m", reduced=True).replace(
        dtype="float32", **change)
    jcfg = jax_config("delphi-2m", reduced=True).replace(
        dtype="float32", **change)
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(3, cfg.vocab_size, (2, 80)).astype(np.int32)
    ages = np.sort(rng.uniform(30, 84, (2, 80)), axis=1).astype(np.float32)
    with torch.no_grad():
        mine = forward(params, cfg, {"tokens": torch.from_numpy(toks),
                                     "ages": torch.from_numpy(ages)},
                       mode="prefill")["logits"].numpy()
    want = np.asarray(jax_forward(
        jax_params(to_flat_numpy(params)), jcfg,
        {"tokens": jnp.asarray(toks), "ages": jnp.asarray(ages)},
        mode="prefill")["logits"])
    np.testing.assert_allclose(mine, want, atol=LOGITS_ATOL, rtol=0)
