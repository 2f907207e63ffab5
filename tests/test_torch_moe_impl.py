"""The MoE dispatch variants of the port (``models.moe.apply_moe``'s
``impl``: ``dense_scan``, ``ragged``, ``ragged_local``, ``dense_einsum``)
and ``moe_impl`` through ``forward``, ``decode_step``, ``forward_suffix``
and ``lm_loss``, plus ``cfg.remat``, on the CPU in fp32 against each other
and against the JAX package.

Weights: JAX's ``init_moe`` for one layer, JAX's ``init_params`` for the
reduced OLMoE-1B-7B and Qwen2-MoE-A2.7B, carried into the port through
``from_jax_flat``; inputs from numpy seeds.

Tolerances (the reference's ``tests/test_moe.py`` holds its dispatches
within 1e-5 of each other and the aux loss within rtol 1e-6):
* the four dispatches against each other and against JAX's same-named
  one: outputs within ``MOE_ATOL`` 1e-5 (measured 1.7e-6 at most), the
  aux loss within rtol 1e-6 (measured 1.2e-7);
* ``ragged``'s gradients (x, router, experts, shared experts) against
  ``dense_scan``'s and ``jax.grad``'s of JAX's ``ragged``: within
  ``GRAD_REL`` 1e-5 of each leaf's largest |g| (measured 8.4e-7);
* logits of the reduced models with ``moe_impl="ragged"`` (train,
  prefill, decode on the ring, a suffix chunk against its whole prefill)
  within ``LM_ATOL`` 5e-5 of JAX's (measured 6.8e-6); ``lm_loss``'s three
  values within rtol 1e-5 and its gradients within 1e-2 of each leaf's
  largest |g| (``tests/test_torch_moe_serve.py``'s allowances; measured
  2.8e-7 and 2.1e-6);
* ``torch._grouped_mm`` in bf16 against the plain grouped product in bf16
  on the same rows: within ``GROUPED_BF16_REL`` 2e-2 of the output's
  largest |y|, the bf16 rounding of each route's outputs (measured 0.0 on
  the CPU); the bf16 ``ragged`` route against bf16 ``dense_scan``: within
  the same share (measured 4.2e-3);
* ``remat``: loss and gradients on and off equal (measured difference
  0.0 on the CPU: the same operations recomputed in the same order).
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
from repro.models import init_params as jax_init_params
from repro.models import mask_padded_positions as jax_mask
from repro.models.moe import apply_moe as jax_apply_moe
from repro.models.moe import init_moe as jax_init_moe
from repro.train.trainer import lm_loss as jax_lm_loss
from repro_torch.configs import get_config
from repro_torch.models import (decode_step, forward, forward_suffix,
                                from_jax_flat, mask_padded_positions, moe)
from repro_torch.models.model import Block
from repro_torch.train import lm_loss, loss_and_grads, make_loss_fn

torch.set_num_threads(2)

IMPLS = ("dense_scan", "ragged", "ragged_local", "dense_einsum")
MOE_ARCHS = ["olmoe-1b-7b", "qwen2-moe-a2.7b"]
MOE_ATOL = 1e-5
AUX_RTOL = 1e-6
GRAD_REL = 1e-5
LM_ATOL = 5e-5
LOSS_RTOL = 1e-5
LM_GRAD_REL = 1e-2
GROUPED_BF16_REL = 2e-2

# (arch, replaced fields): reduced OLMoE (E 4, k 2), reduced Qwen2-MoE (one
# shared expert), and a wider routing (E 16, k 4: some experts get no row)
LAYER_CASES = {"olmoe": ("olmoe-1b-7b", {}),
               "qwen2-moe": ("qwen2-moe-a2.7b", {}),
               "wide": ("qwen2-moe-a2.7b", dict(n_experts=16, top_k=4))}


def jax_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(jax_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _layer(case):
    """One MoE layer of JAX's ``init_moe`` and (2, 24, d) inputs: (cfg,
    jcfg, JAX params, the port's flat weights, x)."""
    arch, change = LAYER_CASES[case]
    cfg = get_config(arch, reduced=True).replace(dtype="float32", **change)
    jcfg = jax_config(arch, reduced=True).replace(dtype="float32", **change)
    jp = jax_init_moe(jax.random.PRNGKey(3 + len(case)), jcfg)
    flat = {"moe/" + k: torch.from_numpy(np.array(v))
            for k, v in jax_flat(jp).items()}
    x = np.random.default_rng(5).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, jp, flat, x


@functools.lru_cache(maxsize=None)
def _arch(arch):
    """A reduced MoE LM from JAX's ``init_params`` (seeded), its weights
    through ``from_jax_flat``: (cfg, jcfg, port params, JAX params)."""
    cfg = get_config(arch, reduced=True).replace(dtype="float32")
    jcfg = jax_config(arch, reduced=True).replace(dtype="float32")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(11))
    params = from_jax_flat(jax_flat(jp), cfg, device="cpu")
    return cfg, jcfg, params, jp


# ---------------------------------------------------------------------------
# apply_moe's four dispatches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_impls_agree_with_each_other_and_jax(case, impl):
    cfg, jcfg, jp, flat, x = _layer(case)
    blk = Block(flat, prefix="")
    y, aux = moe.apply_moe(blk, torch.from_numpy(x), cfg, impl=impl)
    y0, aux0 = moe.apply_moe(blk, torch.from_numpy(x), cfg,
                             impl="dense_scan")
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), y0.numpy(), atol=MOE_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(aux0), rtol=AUX_RTOL)
    jy, jaux = jax_apply_moe(jp, jnp.asarray(x), jcfg, impl=impl)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=MOE_ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_default_impl_is_dense_scan_bit_for_bit(case):
    """No ``impl`` is ``dense_scan``; ``dense_einsum`` runs the same route
    (one card has no model axis to reduce over), so its bits are equal
    too; ``ragged_local`` is ``ragged`` off a mesh, bit for bit."""
    cfg, _, _, flat, x = _layer(case)
    blk = Block(flat, prefix="")
    xt = torch.from_numpy(x)
    y, aux = moe.apply_moe(blk, xt, cfg)
    for impl, other in (("dense_scan", None), ("dense_einsum", None),
                        ("ragged_local", "ragged")):
        y2, aux2 = moe.apply_moe(blk, xt, cfg, impl=impl)
        if other is None:
            assert torch.equal(y, y2) and torch.equal(aux, aux2), impl
        else:
            y3, _ = moe.apply_moe(blk, xt, cfg, impl=other)
            assert torch.equal(y2, y3), impl


def test_unknown_impl_raises():
    cfg, _, _, flat, x = _layer("olmoe")
    with pytest.raises(ValueError, match="unknown MoE impl 'sparse'"):
        moe.apply_moe(Block(flat, prefix=""), torch.from_numpy(x), cfg,
                      impl="sparse")
    params = _arch("olmoe-1b-7b")[2]
    with pytest.raises(ValueError, match="unknown MoE impl"):
        forward(params, get_config("olmoe-1b-7b", reduced=True)
                .replace(dtype="float32"),
                {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                moe_impl="dense")


def _port_grads(flat, x, cfg, impl, g):
    leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.apply_moe(Block(leaves, prefix=""), xt, cfg, impl=impl)
    ((y * torch.from_numpy(g)).sum() + aux).backward()
    out = {k: v.grad.numpy() for k, v in leaves.items()}
    out["x"] = xt.grad.numpy()
    return out


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_ragged_gradients_equal_dense_scan_and_jax(case):
    """d(sum(y * g) + aux) by x and every weight: ``ragged`` against
    ``dense_scan`` and against ``jax.grad`` of JAX's ``ragged``."""
    cfg, jcfg, jp, flat, x = _layer(case)
    g = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    rag = _port_grads(flat, x, cfg, "ragged", g)
    dense = _port_grads(flat, x, cfg, "dense_scan", g)

    def f(p, xx):
        y, aux = jax_apply_moe(p, xx, jcfg, impl="ragged")
        return jnp.sum(y * jnp.asarray(g)) + aux
    jg, jgx = jax.grad(f, argnums=(0, 1))(jp, jnp.asarray(x))
    want = {"moe/" + k: v for k, v in jax_flat(jg).items()}
    want["x"] = np.asarray(jgx)
    assert set(rag) == set(want)
    for k, w in want.items():
        scale = float(np.abs(w).max())
        assert scale > 0 and np.isfinite(rag[k]).all(), k
        for other in (dense[k], w):
            err = float(np.abs(rag[k] - other).max())
            assert err <= GRAD_REL * scale, (k, err, scale)


def test_grouped_product_routes():
    """``grouped_route``: ``torch._grouped_mm`` for bf16 at widths that
    are multiples of 8, where torch has it; the plain loop in fp32 or at
    another width.  Where this torch has it, its bf16 product meets the
    plain grouped product in bf16 on the same sorted rows (empty groups
    included)."""
    rng = np.random.default_rng(2)
    E, K, N = 6, 256, 128
    sizes = np.asarray([5, 0, 17, 1, 0, 9])
    offs = torch.from_numpy(np.cumsum(sizes).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal((int(sizes.sum()), K))
                         .astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((E, K, N)) * K ** -0.5)
                         .astype(np.float32))
    assert moe.grouped_route(x, w) == "plain"
    assert moe.grouped_route(x[:, :250].bfloat16(),
                             w[:, :250].bfloat16()) == "plain"
    want = torch.cat([x[a:b] @ w[e] for e, (a, b) in enumerate(
        zip([0, *offs[:-1].tolist()], offs.tolist()))])
    np.testing.assert_array_equal(moe.grouped_mm(x, w, offs).numpy(),
                                  want.numpy())
    xb, wb = x.bfloat16(), w.bfloat16()
    if not hasattr(torch, "_grouped_mm"):
        assert moe.grouped_route(xb, wb) == "plain"
        return
    assert moe.grouped_route(xb, wb) == "torch._grouped_mm"
    got = moe.grouped_mm(xb, wb, offs).float()
    plain = torch.cat([xb[a:b] @ wb[e] for e, (a, b) in enumerate(
        zip([0, *offs[:-1].tolist()], offs.tolist()))]).float()
    scale = float(plain.abs().max())
    assert float((got - plain).abs().max()) <= GROUPED_BF16_REL * scale


def test_ragged_bf16_route_runs_grouped_mm_and_meets_dense():
    """The bf16 ``ragged`` route (``torch._grouped_mm`` where this torch
    has it) against ``dense_scan`` in bf16 on the same weights: within
    ``GROUPED_BF16_REL`` of the output's largest |y| (bf16 rounding of
    both routes' products)."""
    cfg, _, _, flat, x = _layer("qwen2-moe")
    cfg = cfg.replace(dtype="bfloat16")
    blk = Block({k: (v if k == "moe/router" else v.bfloat16())
                 for k, v in flat.items()}, prefix="")
    xb = torch.from_numpy(x).bfloat16()
    y, aux = moe.apply_moe(blk, xb, cfg, impl="ragged")
    y0, aux0 = moe.apply_moe(blk, xb, cfg)
    assert y.dtype == torch.bfloat16 and torch.equal(aux, aux0)
    scale = float(y0.float().abs().max())
    assert float((y.float() - y0.float()).abs().max()) \
        <= GROUPED_BF16_REL * scale


class _PoisonedGroupedMM(torch.autograd.Function):
    """``torch._grouped_mm`` with NaN written into the rows past the last
    group of its output and of x's gradient: what the product may leave
    there, since it writes neither (on the CPU they read NaN, inf or a
    stale value from run to run)."""

    @staticmethod
    def forward(ctx, x, w, offs):
        ctx.save_for_backward(x, w, offs)
        y = _GROUPED_MM(x, w, offs=offs)
        y[int(offs[-1]):] = float("nan")
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, offs = ctx.saved_tensors
        with torch.enable_grad():
            xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
            gx, gw = torch.autograd.grad(_GROUPED_MM(xr, wr, offs=offs),
                                         (xr, wr), gy)
        gx = gx.clone()
        gx[int(offs[-1]):] = float("nan")
        return gx, gw, None


_GROUPED_MM = getattr(torch, "_grouped_mm", None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_rows_summed_over_expert_shares_equal_the_whole(
        dtype, monkeypatch):
    """``expert_rows`` on one model rank's share of the experts (its own
    experts' rows sorted first, the rest masked: what a rank runs where
    the experts split over ``model``), summed over the 4 shares of E 16,
    top-k 4, equals the whole stack's output, and the gradients of x, of
    the router (the routing weights come from ``route`` on a router that
    requires grad, so x's gradient also flows through the routing) and of
    each share's weights equal the whole's, all finite: in fp32 (the
    plain loop, zeros past the last group) and in bf16, where
    ``torch._grouped_mm`` leaves the rows past its last group unwritten
    and the masks must keep them out of every product and of the routing
    weights' gradient: the product here writes NaN into them, forward and
    backward.  Within ``MOE_ATOL`` in fp32, ``GROUPED_BF16_REL`` of the
    largest |y| in bf16."""
    cfg, _, _, flat, x = _layer("wide")
    E, k = cfg.n_experts, cfg.top_k
    if dtype == torch.bfloat16:
        assert _GROUPED_MM is not None
        monkeypatch.setattr(torch, "_grouped_mm",
                            lambda x, w, offs: _PoisonedGroupedMM.apply(
                                x, w, offs))
    torch.manual_seed(0)
    xs = torch.from_numpy(x).reshape(-1, cfg.d_model).to(dtype)
    ws = {n: flat["moe/" + n].to(dtype) for n in ("w_gate", "w_up",
                                                 "w_down")}
    ct = torch.randn(xs.shape).to(dtype)

    def run(first, n):
        xl = xs.detach().requires_grad_(True)
        rl = flat["moe/router"].detach().requires_grad_(True)
        wl = {m: w[first:first + n].detach().requires_grad_(True)
              for m, w in ws.items()}
        weights, experts, _ = moe.route(rl, xl, k)
        y = moe.expert_rows(xl, weights, experts, wl["w_gate"], wl["w_up"],
                            wl["w_down"], E, first)
        (y.float() * ct.float()).sum().backward()
        return (y.detach().float(), xl.grad.float(), rl.grad,
                {m: w.grad.float() for m, w in wl.items()})
    y0, gx0, gr0, gw0 = run(0, E)
    parts = [run(r * E // 4, E // 4) for r in range(4)]
    y = sum(p[0] for p in parts)
    gx = sum(p[1] for p in parts)
    gr = sum(p[2] for p in parts)
    tol = MOE_ATOL if dtype == torch.float32 else \
        GROUPED_BF16_REL * float(y0.abs().max())
    assert all(bool(torch.isfinite(t).all()) for p in parts
               for t in (p[0], p[1], p[2], *p[3].values()))
    assert float((y - y0).abs().max()) <= tol
    assert float((gx - gx0).abs().max()) <= GROUPED_BF16_REL \
        * float(gx0.abs().max())
    assert float((gr - gr0).abs().max()) <= GROUPED_BF16_REL \
        * float(gr0.abs().max())
    for r, p in enumerate(parts):
        lo = r * E // 4
        for m, g in p[3].items():
            want = gw0[m][lo:lo + E // 4]
            assert float((g - want).abs().max()) <= GROUPED_BF16_REL \
                * float(gw0[m].abs().max()), (r, m)


# ---------------------------------------------------------------------------
# moe_impl through the model and the loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["train", "prefill", "decode", "suffix"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_model_with_ragged_vs_jax(arch, kind):
    """``moe_impl="ragged"``: the train logits and aux loss, the prefill
    logits at each row's last valid token, three decode steps on the ring
    from that prefill against JAX's ``ragged``; a suffix chunk's logits
    (``forward_suffix`` over the first 64 tokens as context) against the
    whole prompt's prefill."""
    cfg, jcfg, params, jp = _arch(arch)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 80)).astype(np.int32)
    tb = {"tokens": torch.from_numpy(toks)}
    jb = {"tokens": jnp.asarray(toks)}
    if kind == "train":
        with torch.no_grad():
            out = forward(params, cfg, tb, moe_impl="ragged")
        want = jax_forward(jp, jcfg, jb, mode="train", moe_impl="ragged")
        np.testing.assert_allclose(out["logits"].numpy(),
                                   np.asarray(want["logits"]), atol=LM_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(float(out["aux_loss"]),
                                   float(want["aux_loss"]), rtol=AUX_RTOL)
        return
    last = np.asarray([79, 51], np.int32)
    with torch.no_grad():
        pre = forward(params, cfg, tb, mode="prefill", cache_width=96,
                      last_index=torch.from_numpy(last), moe_impl="ragged")
    if kind == "suffix":
        # context: the prefill's first 64 positions of row 0
        lc = pre["cache"]["self"]
        ctx = {"k": lc.k[:, :1, :, :64].permute(0, 1, 3, 2, 4),
               "v": lc.v[:, :1, :, :64].permute(0, 1, 3, 2, 4),
               "pos": lc.pos[0, :1, :64]}
        pos = torch.arange(64, 80, dtype=torch.int32)[None]
        with torch.no_grad():
            sfx = forward_suffix(params, cfg,
                                 {"tokens": tb["tokens"][:1, 64:],
                                  "positions": pos}, ctx,
                                 last_index=torch.tensor([15]),
                                 moe_impl="ragged")
        np.testing.assert_allclose(sfx["logits"].numpy(),
                                   pre["logits"][:1].numpy(), atol=LM_ATOL,
                                   rtol=0)
        return
    jpre = jax_forward(jp, jcfg, jb, mode="prefill", cache_width=96,
                       last_index=jnp.asarray(last), moe_impl="ragged")
    np.testing.assert_allclose(pre["logits"].numpy(),
                               np.asarray(jpre["logits"]), atol=LM_ATOL,
                               rtol=0)
    if kind == "prefill":
        return
    cache = mask_padded_positions(pre["cache"], torch.from_numpy(last))
    jcache = jax_mask(jpre["cache"], jnp.asarray(last))
    step = last + 1
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        with torch.no_grad():
            d = decode_step(params, cfg, cache,
                            {"tokens": torch.from_numpy(tok)},
                            torch.from_numpy(step), moe_impl="ragged")
        jd = jax_decode_step(jp, jcfg, jcache, {"tokens": jnp.asarray(tok)},
                             jnp.asarray(step), moe_impl="ragged")
        jcache = jd["cache"]
        np.testing.assert_allclose(d["logits"].numpy(),
                                   np.asarray(jd["logits"]), atol=LM_ATOL,
                                   rtol=0)
        step = step + 1


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_loss_with_ragged_vs_jax(arch):
    """``lm_loss(moe_impl="ragged")`` and its gradients against
    ``jax.grad`` of JAX's ``lm_loss(moe_impl="ragged")``; the port's
    ``make_loss_fn``/``make_train_step`` take the same keyword."""
    cfg, jcfg, params, jp = _arch(arch)
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    grads, m = loss_and_grads(make_loss_fn(cfg, "lm", moe_impl="ragged"),
                              params, {"tokens": torch.from_numpy(toks)})
    (_, jm), jg = jax.value_and_grad(
        lambda p: (lambda mm: (mm["loss"], mm))(
            jax_lm_loss(p, jcfg, {"tokens": jnp.asarray(toks)},
                        moe_impl="ragged")), has_aux=True)(jp)
    for k in ("loss", "event_ce", "aux_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    want = jax_flat(jg)
    assert set(grads) == set(want)
    for k, g in grads.items():
        scale = float(np.abs(want[k]).max())
        err = float(np.abs(g.numpy() - want[k]).max())
        assert scale > 0 and err <= LM_GRAD_REL * scale, (k, err, scale)
    # the direct call equals the factory's
    with torch.no_grad():
        direct = lm_loss(params, cfg, {"tokens": torch.from_numpy(toks)},
                         moe_impl="ragged")
    assert float(direct["loss"]) == float(m["loss"])


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------
REMAT_ARCHS = ["olmoe-1b-7b", "delphi-2m", "mamba2-780m", "zamba2-1.2b",
               "seamless-m4t-large-v2"]


def _batch(cfg, rng):
    b = {"tokens": torch.from_numpy(
        rng.integers(3, cfg.vocab_size, (2, 24)).astype(np.int32))}
    if cfg.age_encoding:
        ages = np.sort(rng.uniform(0, 80, (2, 24)), axis=1).astype(np.float32)
        b["ages"] = torch.from_numpy(ages)
        b["targets"] = torch.roll(b["tokens"], -1, 1)
        b["target_dt"] = torch.from_numpy(np.abs(
            rng.standard_normal((2, 24))).astype(np.float32))
        b["loss_mask"] = torch.ones((2, 24))
    if cfg.frontend == "audio_frames":
        b["frames"] = torch.from_numpy(rng.standard_normal(
            (2, 6, cfg.d_model)).astype(np.float32))
    return b


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_changes_no_loss_or_gradient(arch):
    """``cfg.remat`` on the training route: every layer checkpointed (the
    decoder's, the encoder's, Mamba2's, the hybrid's shared block), its
    activations recomputed in the backward.  Loss and gradients equal the
    route without it (measured difference 0.0)."""
    from repro_torch.models import init_params
    cfg = get_config(arch, reduced=True).replace(dtype="float32")
    params = init_params(cfg, seed=2, device="cpu")
    batch = _batch(cfg, np.random.default_rng(8))
    objective = "delphi" if cfg.age_encoding else "lm"
    g0, m0 = loss_and_grads(make_loss_fn(cfg, objective), params, batch)
    rcfg = cfg.replace(remat=True)
    g1, m1 = loss_and_grads(make_loss_fn(rcfg, objective), params, batch)
    assert float(m1["loss"]) == float(m0["loss"])
    diff = max(float((g1[k] - g0[k]).abs().max()) for k in g0)
    assert diff == 0.0, diff


def test_remat_checkpoints_each_layer(monkeypatch):
    """With ``remat`` the training forward goes through
    ``torch.utils.checkpoint`` once a layer (2 here); without it, or when
    serving, never."""
    from repro_torch.models import init_params
    from repro_torch.models import model as model_lib
    cfg = get_config("olmoe-1b-7b", reduced=True).replace(dtype="float32")
    params = init_params(cfg, seed=2, device="cpu")
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(fn, *a, **kw):
        calls.append(fn)
        return real(fn, *a, **kw)
    monkeypatch.setattr(model_lib.torch.utils.checkpoint, "checkpoint",
                        counting)
    tb = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    with torch.no_grad():
        forward(params, cfg.replace(remat=True), tb)
        forward(params, cfg.replace(remat=True), tb, mode="prefill")
    assert calls == []
    forward(params, cfg, tb, differentiable=True)
    assert calls == []
    forward(params, cfg.replace(remat=True), tb, differentiable=True)
    assert len(calls) == cfg.n_layers
