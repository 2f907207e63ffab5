"""The port's mixture of experts against the JAX package's, on the CPU in
fp32 unless a case says otherwise: the router, the MoE MLP under each of
the reference's three dispatches, the reduced OLMoE-1B-7B and
Qwen2-MoE-A2.7B in every mode of ``forward`` and ``decode_step``, the
configs and the weights made on the device.

Weights: the JAX package's ``init_moe`` for one layer, carried across by
name; the port's numpy-seeded ``init_params`` for whole models, handed to
the JAX model through the flat checkpoint layout.

Tolerances, measured on these inputs (CPU, fp32):
* ``route``: the same experts; weights within 3.9e-7, aux within 4.8e-7
  (allowed 1e-6 both).
* ``apply_moe`` against JAX's ``dense_scan``, ``ragged`` and
  ``dense_einsum`` (which ``tests/test_moe.py`` holds within 1e-5 of each
  other): within 1.5e-6 (allowed 1e-5); the aux within 4.8e-7 (1e-6).
* Logits of the reduced models (train, prefill, decode on the ring and on
  the paged pool): within 5.7e-6 (allowed ``LM_ATOL`` 5e-5, the dense
  LMs' allowance); the aux summed over the 2 layers within 9.5e-7
  (allowed 1e-6 a layer).
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
from repro.models.attention import PagedCache as JaxPagedCache
from repro.models.moe import apply_moe as jax_apply_moe
from repro.models.moe import init_moe as jax_init_moe
from repro.models.moe import route as jax_route
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import (PagedCache, cast_params, decode_step, forward,
                                from_jax_flat, init_params,
                                init_params_on_device, mask_padded_positions,
                                to_flat_numpy)
from repro_torch.models import moe
from repro_torch.models.model import Block
from repro_torch.models.params import MATMUL_KEYS, param_shapes

torch.set_num_threads(2)

MOE_ARCHS = ["olmoe-1b-7b", "qwen2-moe-a2.7b"]
LM_ATOL = 5e-5
ROUTE_ATOL = 1e-6
MOE_ATOL = 1e-5

# (arch, replaced fields): reduced OLMoE (E 4, k 2), reduced Qwen2-MoE (one
# shared expert), and a wider routing (E 16, k 4)
LAYER_CASES = {"olmoe": ("olmoe-1b-7b", {}),
               "qwen2-moe": ("qwen2-moe-a2.7b", {}),
               "wide": ("qwen2-moe-a2.7b", dict(n_experts=16, top_k=4))}


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
def _layer(case):
    """One MoE layer of JAX's ``init_moe`` and (2, 24, d) inputs: (cfg,
    jcfg, JAX params, the port's Block over the same weights, x)."""
    arch, change = LAYER_CASES[case]
    cfg = get_config(arch, reduced=True).replace(dtype="float32", **change)
    jcfg = jax_config(arch, reduced=True).replace(dtype="float32", **change)
    jp = jax_init_moe(jax.random.PRNGKey(len(case)), jcfg)
    flat = {"moe/" + k: torch.from_numpy(np.array(v))
            for k, v in jax_flat(jp).items()}
    x = np.random.default_rng(1).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, jp, Block(flat, prefix=""), x


# ---------------------------------------------------------------------------
# the router and the MoE MLP
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_route_vs_jax(case):
    cfg, jcfg, jp, blk, x = _layer(case)
    flat = x.reshape(-1, cfg.d_model)
    w, e, aux = moe.route(blk["moe/router"], torch.from_numpy(flat),
                          cfg.top_k)
    jw, je, jaux = jax_route(jp, jnp.asarray(flat), jcfg)
    assert e.shape == (48, cfg.top_k) and w.dtype == torch.float32
    assert (e.numpy() == np.asarray(je)).all()
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=ROUTE_ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=ROUTE_ATOL,
                               rtol=0)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_route_ties_go_to_the_lower_index():
    """Equal probabilities: JAX's ``lax.top_k`` takes the lower index
    first; ``torch.topk`` does not promise it (and on the CPU returns
    experts 1 and 3 of four equal ones).  A zero router gives every token
    a uniform row (all E tied), and a router whose columns 1, 3 and 5 are
    equal ties those three experts at the top."""
    E, k, d = 8, 2, 16
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, d)).astype(np.float32)
    col = np.abs(rng.standard_normal((d, 1))).astype(np.float32)
    tied = np.concatenate([-col] * E, axis=1)
    tied[:, [1, 3, 5]] = col
    xs = np.abs(x)                     # every logit of 1, 3, 5 the largest
    jcfg = jax_config("olmoe-1b-7b", reduced=True).replace(
        n_experts=E, top_k=k)
    for router, inp in ((np.zeros((d, E), np.float32), x), (tied, xs)):
        _, je, _ = jax_route({"router": jnp.asarray(router)},
                             jnp.asarray(inp), jcfg)
        _, e, _ = moe.route(torch.from_numpy(router), torch.from_numpy(inp),
                            k)
        assert (e.numpy() == np.asarray(je)).all()
    assert (e.numpy() == [1, 3]).all()
    _, e, _ = moe.route(torch.zeros((d, E)), torch.from_numpy(x), k)
    assert (e.numpy() == [0, 1]).all()


@pytest.mark.parametrize("impl", ["dense_scan", "ragged", "dense_einsum"])
@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_apply_moe_vs_jax(case, impl):
    cfg, jcfg, jp, blk, x = _layer(case)
    y, aux = moe.apply_moe(blk, torch.from_numpy(x), cfg)
    jy, jaux = jax_apply_moe(jp, jnp.asarray(x), jcfg, impl=impl)
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=MOE_ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=ROUTE_ATOL,
                               rtol=0)


def test_apply_moe_token_chunks(monkeypatch):
    """Chunks of the token axis (7 tokens here, the last one short) give
    the one-chunk result; the shared experts contribute."""
    cfg, _, _, blk, x = _layer("qwen2-moe")
    whole, aux = moe.apply_moe(blk, torch.from_numpy(x), cfg)
    assert moe.token_chunk(cfg) >= x.shape[0] * x.shape[1]
    monkeypatch.setattr(moe, "CHUNK_ELEMENTS",
                        7 * cfg.n_experts * max(cfg.d_model, cfg.moe_d_ff))
    assert moe.token_chunk(cfg) == 7
    parts, aux2 = moe.apply_moe(blk, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), atol=1e-6,
                               rtol=0)
    assert float(aux2) == float(aux)
    no_shared = Block({k: v for k, v in blk.params.items()
                       if "shared" not in k}, prefix="")
    routed, _ = moe.apply_moe(no_shared, torch.from_numpy(x), cfg)
    assert float((whole - routed).abs().max()) > 1e-3


def test_token_chunk_budget():
    """Qwen2-MoE at full width: 1,092 tokens a chunk, each (E, t, f) and
    (E, t, d) intermediate within 2^27 elements; OLMoE: 1,024."""
    q, o = get_config("qwen2-moe-a2.7b"), get_config("olmoe-1b-7b")
    assert moe.token_chunk(q) == 1092 and moe.token_chunk(o) == 1024
    for c in (q, o):
        assert moe.token_chunk(c) * c.n_experts \
            * max(c.d_model, c.moe_d_ff) <= moe.CHUNK_ELEMENTS


# ---------------------------------------------------------------------------
# the reduced models against JAX's forward / decode_step
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _arch(arch):
    cfg = get_config(arch, reduced=True).replace(dtype="float32")
    jcfg = jax_config(arch, reduced=True).replace(dtype="float32")
    params = init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(7)
    for k in ("layers/attn/bq", "layers/attn/bk", "layers/attn/bv"):
        if k in params:      # JAX initialises them to zero: draw them
            params[k] = torch.from_numpy(
                (0.5 * rng.standard_normal(tuple(params[k].shape)))
                .astype(np.float32))
    return cfg, jcfg, params, jax_params(to_flat_numpy(params))


def _paged_layout(k, v, pos, bs, seed):
    """A ring (L, B, Hkv, W, hd) and its positions (L, B, W) laid out as a
    pool of ``bs``-token blocks at shuffled ids (block 0 the trash block)
    with one table row per slot: numpy arrays for both packages."""
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
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_reduced_moe_vs_jax(arch, kind):
    """The train logits (and the routers' aux loss, summed over the
    layers); the prefill logits at each row's last valid token of a
    right-padded batch; three decode steps from that prefill (padded
    positions masked) on the ring and on a paged pool holding the same
    tokens in shuffled blocks."""
    cfg, jcfg, params, jp = _arch(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 100)).astype(np.int32)
    if kind == "train":
        with torch.no_grad():
            mine = forward(params, cfg, {"tokens": torch.from_numpy(toks)},
                           mode="train")
            diff = forward(params, cfg, {"tokens": torch.from_numpy(toks)},
                           mode="train", differentiable=True)
        want = jax_forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                           mode="train")
        for out in (mine, diff):
            np.testing.assert_allclose(out["logits"].numpy(),
                                       np.asarray(want["logits"]),
                                       atol=LM_ATOL, rtol=0)
            np.testing.assert_allclose(float(out["aux_loss"]),
                                       float(want["aux_loss"]),
                                       atol=cfg.n_layers * ROUTE_ATOL, rtol=0)
        assert float(mine["aux_loss"]) > 0
        return
    W = 128
    last = np.asarray([99, 69], np.int32)
    with torch.no_grad():
        pre = forward(params, cfg, {"tokens": torch.from_numpy(toks)},
                      mode="prefill", cache_width=W,
                      last_index=torch.from_numpy(last))
    jpre = jax_forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                       mode="prefill", cache_width=W,
                       last_index=jnp.asarray(last))
    if kind == "prefill":
        np.testing.assert_allclose(pre["logits"].numpy(),
                                   np.asarray(jpre["logits"]), atol=LM_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(float(pre["aux_loss"]),
                                   float(jpre["aux_loss"]),
                                   atol=cfg.n_layers * ROUTE_ATOL, rtol=0)
        return
    cache = mask_padded_positions(pre["cache"], torch.from_numpy(last))
    jcache = jax_mask(jpre["cache"], jnp.asarray(last))
    if kind == "decode-paged":
        lc = cache["self"]
        kp, vp, pp, table = _paged_layout(lc.k.numpy(), lc.v.numpy(),
                                          lc.pos.numpy(), 16, seed=3)
        cache = {"self": PagedCache(*(torch.from_numpy(a.copy())
                                      for a in (kp, vp, pp, table)))}
        jcache = {"self": JaxPagedCache(*(jnp.asarray(a)
                                          for a in (kp, vp, pp, table)))}
    step = last + 1
    for i in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        with torch.no_grad():
            d = decode_step(params, cfg, cache,
                            {"tokens": torch.from_numpy(tok)},
                            torch.from_numpy(step))
        jd = jax_decode_step(jp, jcfg, jcache, {"tokens": jnp.asarray(tok)},
                             jnp.asarray(step))
        jcache = jd["cache"]
        np.testing.assert_allclose(d["logits"].numpy(),
                                   np.asarray(jd["logits"]), atol=LM_ATOL,
                                   rtol=0)
        step = step + 1


# ---------------------------------------------------------------------------
# configs, the bridge, and the weights made on the device
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_configs_equal_jax(arch):
    """The copied configs and their ``reduced()`` equal JAX's field for
    field (the MoE fields included)."""
    for red in (False, True):
        mine, want = get_config(arch, reduced=red), jax_config(arch,
                                                               reduced=red)
        for f in ("name", "arch_type", "citation", "n_layers", "d_model",
                  "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size",
                  "qkv_bias", "norm", "activation", "rope_theta",
                  "max_seq_len", "tie_embeddings", "sliding_window",
                  "n_experts", "top_k", "n_shared_experts", "moe_d_ff",
                  "router_aux_coef", "dtype"):
            assert getattr(mine, f) == getattr(want, f), (arch, red, f)


def test_config_checks_the_moe_fields():
    """``0 < top_k <= n_experts`` as JAX asserts it; and ``arch_type="moe"``
    with no experts, which JAX's ``__post_init__`` lets through, raises."""
    base = get_config("olmoe-1b-7b", reduced=True)
    with pytest.raises(ValueError, match="top_k"):
        base.replace(top_k=5)
    with pytest.raises(ValueError, match="top_k"):
        base.replace(top_k=0)
    with pytest.raises(ValueError, match="n_experts > 0"):
        ModelConfig(name="x", arch_type="moe")
    assert jax_config("olmoe-1b-7b").replace(n_experts=0, top_k=0).n_experts \
        == 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bridge_round_trip_moe(arch, tmp_path):
    """JAX ``init_params`` -> flat npz -> the port -> npz, exactly; the
    port's ``init_params`` and the device route have JAX's keys and
    shapes."""
    jcfg = jax_config(arch, reduced=True).replace(dtype="float32")
    cfg = get_config(arch, reduced=True).replace(dtype="float32")
    flat = jax_flat(jax_init_params(jcfg, jax.random.PRNGKey(2)))
    np.savez(tmp_path / "params.npz", **flat)
    with np.load(tmp_path / "params.npz") as data:
        params = from_jax_flat({k: data[k] for k in data.files}, cfg,
                               device="cpu")
    back = to_flat_numpy(params)
    assert set(back) == set(flat)
    assert all((back[k] == flat[k]).all() for k in flat)
    assert not any(k.startswith("layers/mlp/") for k in flat)
    want = {k: v.shape for k, v in flat.items()}
    for made in (init_params(cfg, seed=0, device="cpu"),
                 init_params_on_device(cfg, seed=0, device="cpu")):
        assert {k: tuple(v.shape) for k, v in made.items()} == want


def test_init_scales_follow_jax():
    """The reference's ``init_moe`` scales: d^-0.5 for router, gate and up,
    f^-0.5 for the experts' down, (n_shared f)^-0.5 for the shared down
    (checked on the standard deviations of the draws, both routes)."""
    cfg = get_config("qwen2-moe-a2.7b", reduced=True).replace(
        dtype="float32", n_shared_experts=2)
    d, f = cfg.d_model, cfg.moe_d_ff
    want = {"layers/moe/router": d ** -0.5, "layers/moe/w_gate": d ** -0.5,
            "layers/moe/w_up": d ** -0.5, "layers/moe/w_down": f ** -0.5,
            "layers/moe/shared/w_gate": d ** -0.5,
            "layers/moe/shared/w_down": (2 * f) ** -0.5}
    for made in (init_params(cfg, seed=0, device="cpu"),
                 init_params_on_device(cfg, seed=0, device="cpu")):
        for k, s in want.items():
            assert abs(float(made[k].float().std()) / s - 1) < 0.05, k


def test_device_route_on_the_cpu():
    """``init_params_on_device``: MATMUL_KEYS leaves in the activation
    dtype, the rest (the router, the norms) fp32; ``cast_params`` and the
    engine keep those very tensors (no fp32 copy of the model is made);
    the same seed gives the same tensors, another seed others; the fp32
    config gets the same draws (its bf16 twin is their rounding)."""
    from repro_torch.serve import BatchedEngine
    cfg = get_config("qwen2-moe-a2.7b", reduced=True)
    assert cfg.dtype == "bfloat16"
    a = init_params_on_device(cfg, seed=3, device="cpu")
    assert set(a) == set(param_shapes(cfg))
    for k, v in a.items():
        want = torch.bfloat16 if k in MATMUL_KEYS else torch.float32
        assert v.dtype == want and v.device.type == "cpu", k
    assert a["layers/moe/router"].dtype == torch.float32
    w = cast_params(a, cfg)
    assert all(w[k] is a[k] for k in a)
    eng = BatchedEngine(a, cfg, slots=2, max_context=64, device="cpu")
    assert all(eng._wparams[k] is a[k] for k in a)
    b = init_params_on_device(cfg, seed=3, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = init_params_on_device(cfg, seed=4, device="cpu")
    assert not torch.equal(a["layers/moe/w_up"], c["layers/moe/w_up"])
    f32 = init_params_on_device(cfg.replace(dtype="float32"), seed=3,
                                device="cpu")
    assert all(f32[k].dtype == torch.float32 for k in f32)
    assert all(torch.equal(f32[k].to(a[k].dtype), a[k]) for k in a)


def test_router_rows_do_not_depend_on_the_token_count():
    """``router_logits`` computes every row in an (ROUTER_ROWS, d) x (d, E)
    product, so a row's logits are the same bits whether it is routed
    with 8 tokens, a 64-token chunk or a 1,000-token prefill (the card's
    fp32 kernels sum a row in another order as the row count changes);
    and they equal the one-product logits within fp32 rounding."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1000, 64)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((64, 12)).astype(np.float32))
    whole = moe.router_logits(r, x)
    for n in (8, 64, 300):
        assert torch.equal(moe.router_logits(r, x[:n]), whole[:n])
    np.testing.assert_allclose(whole.numpy(), (x @ r).numpy(), atol=1e-5,
                               rtol=0)
    assert moe.router_logits(r, x[:3].to(torch.bfloat16)).dtype \
        == torch.float32
