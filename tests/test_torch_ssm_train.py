"""Mamba2 training on the port against the JAX package, in fp32 on the CPU.

The training route of a Mamba2 layer is the plain SSD route of
``repro_torch.models.ssm.ssd_chunked`` (``differentiable=True``): the
intra-chunk term and the chunk states in plain fp32 ops, as the JAX
package's ``ssd_chunked`` computes them (the ``ssd_intra`` kernel has no
backward).  The same numpy-seeded inputs go through both packages:

* the plain route's ``y`` and final state against JAX's ``ssd_chunked`` at
  chunks 8, 16 and 32 and across an ``h0`` continuation, and against the
  port's kernel route (its plain version on the CPU);
* the gradients of a scalar of ``y`` (a fixed random weighting) with
  respect to x, dt, A, B and C against ``jax.grad``;
* a steep decay (``cum`` falling by 10 a step) gives no NaN, forward or
  backward;
* reduced ``mamba2-780m``: ``lm_loss`` and the gradient of every parameter
  against ``jax.value_and_grad`` of JAX's ``lm_loss``, then the training
  CLI for 2 steps on the CPU.

Tolerances, measured on these inputs (CPU, fp32): ``y`` and ``h`` within
2.3e-6 of JAX's (allowed 1e-4, ``tests/test_ssm.py``'s); the plain route
equal to the kernel route's plain version bit for bit on the CPU (allowed
1e-5; the card holds the kernel itself to 1e-4, ``test_torch_cuda.py``);
the SSD gradients within 2.4e-7 of each input's largest |g| (allowed 1e-4
relative); reduced Mamba2's loss within 1.4e-7 relative (allowed 1e-5) and
its parameter gradients within 2.6e-6 of each leaf's largest |g| (allowed
1e-4 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import ssm as jssm
from repro.train.trainer import lm_loss as jax_lm_loss
from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import forward, init_params, to_flat_numpy
from repro_torch.models import ssm as tssm
from repro_torch.train import loss_and_grads, make_loss_fn

torch.set_num_threads(2)

SSD_ATOL = 1e-4
ROUTE_ATOL = 1e-5
GRAD_REL = 1e-4
LOSS_RTOL = 1e-5


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


def check_grads(grads, want, rel=GRAD_REL):
    """Every gradient finite, nonzero and within ``rel`` of its leaf's
    largest |g| of the reference's."""
    assert set(grads) == set(want)
    for k, g in grads.items():
        g = np.asarray(g)
        scale = float(np.abs(want[k]).max())
        assert scale > 0 and np.isfinite(g).all(), k
        err = float(np.abs(g - want[k]).max())
        assert err <= rel * scale, (k, err, scale)


def ssd_inputs(seed, B=2, S=64, H=4, P=8, N=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (B, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, (H,)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_plain_ssd_route_vs_jax(chunk):
    arrs = ssd_inputs(chunk)
    jy, jh = jssm.ssd_chunked(*(jnp.asarray(a) for a in arrs), chunk)
    t = [torch.from_numpy(a) for a in arrs]
    y, h = tssm.ssd_chunked(*t, chunk, differentiable=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=SSD_ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=SSD_ATOL)
    ky, kh = tssm.ssd_chunked(*t, chunk)             # the kernel's route
    np.testing.assert_allclose(y.numpy(), ky.numpy(), atol=ROUTE_ATOL)
    np.testing.assert_allclose(h.numpy(), kh.numpy(), atol=ROUTE_ATOL)


def test_plain_ssd_route_h0_continuation_vs_jax():
    """Two halves, the second starting from the first's state, equal the
    whole; both against JAX's ``ssd_chunked`` with the same ``h0``."""
    x, dt, A, Bm, Cm = ssd_inputs(3, S=96)
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    y, h = tssm.ssd_chunked(*t, 16, differentiable=True)
    half = [a[:, :48] if a.ndim > 1 else a for a in t]
    rest = [a[:, 48:] if a.ndim > 1 else a for a in t]
    y1, h1 = tssm.ssd_chunked(*half, 16, differentiable=True)
    y2, h2 = tssm.ssd_chunked(*rest, 16, h0=h1, differentiable=True)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               atol=SSD_ATOL)
    np.testing.assert_allclose(h2.numpy(), h.numpy(), atol=SSD_ATOL)
    jy2, jh2 = jssm.ssd_chunked(*(jnp.asarray(a.numpy()) for a in rest), 16,
                                h0=jnp.asarray(h1.numpy()))
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), atol=SSD_ATOL)
    np.testing.assert_allclose(h2.numpy(), np.asarray(jh2), atol=SSD_ATOL)


def test_plain_ssd_route_gradients_vs_jax_grad():
    """d(sum(w * y) + sum(v * h))/d(x, dt, A, B, C) against ``jax.grad``."""
    arrs = ssd_inputs(7, S=64)
    rng = np.random.default_rng(8)
    w = rng.standard_normal(arrs[0].shape).astype(np.float32)
    v = rng.standard_normal((2, 4, 16, 8)).astype(np.float32)

    def jloss(*a):
        y, h = jssm.ssd_chunked(*a, 16)
        return jnp.sum(y * w) + jnp.sum(h * v)
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in arrs))
    t = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    y, h = tssm.ssd_chunked(*t, 16, differentiable=True)
    ((y * torch.from_numpy(w)).sum() + (h * torch.from_numpy(v)).sum()
     ).backward()
    names = ("x", "dt", "A", "B", "C")
    check_grads({n: a.grad.numpy() for n, a in zip(names, t)},
                {n: np.asarray(g) for n, g in zip(names, jg)})


def test_plain_ssd_route_has_no_nan_at_steep_decay():
    """A decay of exp(-10) a step: above the diagonal exp(cum_i - cum_j)
    would overflow to inf and its masked product's gradient to NaN."""
    Q = 32
    x = torch.ones((1, Q, 2, 4), requires_grad=True)
    dt = torch.full((1, Q, 2), 10.0, requires_grad=True)
    A = torch.full((2,), -1.0, requires_grad=True)
    Bm = torch.ones((1, Q, 3), requires_grad=True)
    Cm = torch.ones((1, Q, 3), requires_grad=True)
    y, h = tssm.ssd_chunked(x, dt, A, Bm, Cm, Q, differentiable=True)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    (y.sum() + h.sum()).backward()
    for t in (x, dt, A, Bm, Cm):
        assert bool(torch.isfinite(t.grad).all())


def test_reduced_mamba2_lm_loss_and_gradients_vs_jax():
    cfg = get_config("mamba2-780m", reduced=True).replace(dtype="float32")
    jcfg = jax_config("mamba2-780m", reduced=True).replace(dtype="float32")
    params = init_params(cfg, seed=2, device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 80)).astype(np.int32)
    grads, m = loss_and_grads(make_loss_fn(cfg, "lm"), params,
                              {"tokens": torch.from_numpy(toks)})
    (jl, jg) = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, jcfg, {"tokens": jnp.asarray(toks)})[
            "loss"]))(jax_params(to_flat_numpy(params)))
    np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=LOSS_RTOL)
    check_grads({k: g.numpy() for k, g in grads.items()}, jax_flat(jg))


def test_mamba2_train_cli_runs_on_the_cpu(tmp_path):
    out = launch_train.main(["--arch", "mamba2-780m", "--reduced",
                             "--steps", "2", "--batch", "2", "--seq-len",
                             "40", "--device", "cpu",
                             "--out", str(tmp_path)])
    assert out["cfg"].arch_type == "ssm" and out["target_tokens"] == 2 * 2 * 39
    assert all(np.isfinite(out["history"]["loss"]))
    assert not any(v.requires_grad for v in out["params"].values())
    with torch.no_grad():
        lg = forward(out["params"], out["cfg"],
                     {"tokens": torch.zeros((1, 8), dtype=torch.int64)},
                     mode="prefill")["logits"]
    assert lg.shape == (1, 1, out["cfg"].vocab_size)
    assert (tmp_path / "params.npz").exists()
