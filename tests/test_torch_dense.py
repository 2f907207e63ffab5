"""The port's dense knobs against the JAX package's, on the CPU in fp32
unless a case says otherwise: RoPE, the SwiGLU MLP and RMSNorm, the blocked
route of ``chunked_attention``, and the model entry points of the five dense
architectures this port adds (TinyLlama, H2O-Danube, Qwen2.5, DeepSeek,
Delphi-100M), reduced.

Weights: the port's numpy-seeded ``init_params``, handed to the JAX model
through the flat checkpoint layout; Qwen2.5's QKV biases are drawn at
random (JAX initialises them to zero, which would test nothing).

Tolerances, measured on these inputs (CPU, fp32 unless stated):
* RoPE's frequency table equals XLA's bit for bit (each step of the fp32
  chain correctly rounded); the rotation of (2, 4096, 4, 64) inputs at
  positions 0-4095 agrees within 4.8e-7 in fp32 (``cos``/``sin`` ulps) at
  theta 10^4 and 10^6, and within one bf16 ulp of |x| <= 8 in bf16 (3.9e-3
  measured).  Allowed: 2e-6 and 1.6e-2.
* SwiGLU: 1.2e-6 measured, allowed 1e-5 (fp32 products in other orders).
* Blocked ``chunked_attention`` at Sq = Skv = 1024 (causal; GQA 4/1; GQA
  4/1 with window 64): output within 6e-7 of JAX's, gradients of a
  weighted sum within 7e-7 of each leaf's largest |g|.  Allowed 1e-5 and
  1e-5 relative; the blocked route also equals the dense route within 1e-5.
* Logits of the reduced archs: generic LMs within 6.9e-6 (train, prefill,
  decode on the ring and on the paged pool), Delphi-100M within 7.9e-4 (the
  age-encoding table's ulp, ROADMAP §C).  Allowed 5e-5 and 2e-3.
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
from repro.models.attention import chunked_attention as jax_chunked
from repro.models.layers import apply_mlp as jax_apply_mlp
from repro.models.layers import apply_rope as jax_apply_rope
from repro.models.layers import rope_frequencies as jax_rope_frequencies
from repro.train import checkpoint as jax_ckpt
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.models import (PagedCache, decode_step, forward,
                                from_jax_flat, init_params,
                                make_decode_cache, mask_padded_positions,
                                to_flat_numpy)
from repro_torch.models.attention import chunked_attention
from repro_torch.models.layers import (apply_rope, apply_swiglu,
                                       rope_frequencies)
from repro_torch.train import checkpoint

torch.set_num_threads(2)

NEW_ARCHS = ["tinyllama-1.1b", "h2o-danube-1.8b", "qwen2.5-32b",
             "deepseek-7b", "delphi-100m"]
LM_ATOL = 5e-5
DELPHI_ATOL = 2e-3


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


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hd", [64, 80, 128])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_frequencies_equal_xla(hd, theta):
    want = np.asarray(jax_rope_frequencies(hd, theta))
    assert (rope_frequencies(hd, theta).numpy() == want).all()


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-6),
                                        ("bfloat16", 1.6e-2)])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_vs_jax(dtype, atol, theta):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4096, 4, 64)).astype(np.float32)
    pos = np.arange(4096, dtype=np.int32)
    want = np.asarray(jax_apply_rope(jnp.asarray(x).astype(dtype),
                                     jnp.asarray(pos), theta)
                      .astype(jnp.float32))
    mine = apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(pos), theta)
    assert mine.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(mine.float().numpy(), want, atol=atol, rtol=0)
    # per-row positions (B, S) rotate like the shared ones
    per_row = apply_rope(torch.from_numpy(x[:, :8]),
                         torch.arange(8)[None].expand(2, 8) + 4000, theta)
    shared = apply_rope(torch.from_numpy(x[:, :8]),
                        torch.arange(4000, 4008), theta)
    assert torch.equal(per_row, shared)


def test_swiglu_mlp_vs_jax():
    cfg = jax_config("tinyllama-1.1b", reduced=True).replace(dtype="float32")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 256)).astype(np.float32)
    w = {k: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
         for k, s in (("w_gate", (256, 512)), ("w_up", (256, 512)),
                      ("w_down", (512, 256)))}
    want = np.asarray(jax_apply_mlp({k: jnp.asarray(v) for k, v in w.items()},
                                    jnp.asarray(x), cfg))
    mine = apply_swiglu(torch.from_numpy(x), *(torch.from_numpy(w[k]) for k
                                               in ("w_gate", "w_up",
                                                   "w_down")))
    np.testing.assert_allclose(mine.numpy(), want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the blocked route of chunked_attention (training at S 1024)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Hkv,G,window", [(2, 1, None), (1, 4, None),
                                          (1, 4, 64)],
                         ids=["causal", "gqa", "gqa-window"])
def test_blocked_chunked_attention_vs_jax(Hkv, G, window):
    B, S, hd = 2, 1024, 32
    rng = np.random.default_rng(Hkv * 10 + G)
    q = rng.standard_normal((B, S, Hkv * G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    w = rng.standard_normal((B, S, Hkv * G, hd)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)

    def jloss(q, k, v):
        o = jax_chunked(q, k, v, jnp.asarray(pos), jnp.asarray(pos),
                        causal=True, window=window, q_per_kv=G)
        return (o * w).sum(), o
    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    o = chunked_attention(tq, tk, tv, tpos, tpos, causal=True, window=window,
                          q_per_kv=G)
    (o * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), atol=1e-5,
                               rtol=0)
    for mine, want in zip((tq, tk, tv), jg):
        want = np.asarray(want)
        err = np.abs(mine.grad.numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), err
    with torch.no_grad():
        dense = chunked_attention(tq, tk, tv, tpos, tpos, causal=True,
                                  window=window, q_per_kv=G, q_block=S,
                                  kv_block=S)
    np.testing.assert_allclose(o.detach().numpy(), dense.numpy(), atol=1e-5,
                               rtol=0)


def test_blocked_route_pads_ragged_lengths_and_masks_invalid_keys():
    """Sq, Skv not block multiples, k_pos -1 keys: the blocked route equals
    the dense one (the same function, summed in another order)."""
    rng = np.random.default_rng(3)
    B, Sq, Skv, hd = 1, 600, 700, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, Sq, 2, hd), (B, Skv, 1, hd), (B, Skv, 1, hd)))
    qp = torch.arange(100, 100 + Sq)
    kp = torch.arange(Skv)
    kp[::7] = -1
    blocked = chunked_attention(q, k, v, qp, kp, causal=True, q_per_kv=2)
    dense = chunked_attention(q, k, v, qp, kp, causal=True, q_per_kv=2,
                              q_block=Sq, kv_block=Skv)
    np.testing.assert_allclose(blocked.numpy(), dense.numpy(), atol=1e-5,
                               rtol=0)


# ---------------------------------------------------------------------------
# the reduced archs against JAX's forward / decode_step
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _arch(arch):
    cfg = get_config(arch, reduced=True).replace(dtype="float32")
    jcfg = jax_config(arch, reduced=True).replace(dtype="float32")
    params = init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(7)
    for k in ("layers/attn/bq", "layers/attn/bk", "layers/attn/bv"):
        if k in params:
            params[k] = torch.from_numpy(
                (0.5 * rng.standard_normal(tuple(params[k].shape)))
                .astype(np.float32))
    return cfg, jcfg, params, jax_params(to_flat_numpy(params))


def _batch(cfg, B=2, S=100, seed=0):
    """Histories longer than Danube's reduced window of 64."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, cfg.vocab_size, (B, S)).astype(np.int32)
    ages = np.sort(rng.uniform(30, 84, (B, S)), axis=1).astype(np.float32)
    b = {"tokens": toks}
    if cfg.age_encoding:
        b["ages"] = ages
    return b


def _to(b, lib):
    if lib == "jax":
        return {k: jnp.asarray(v) for k, v in b.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _atol(cfg):
    return DELPHI_ATOL if cfg.age_encoding else LM_ATOL


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
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_reduced_arch_vs_jax(arch, kind):
    """After ``tests/test_models_smoke.py``: the train logits; the prefill
    logits at each row's last valid token of a right-padded batch; three
    decode steps from that prefill (padded positions masked) on the ring
    and on a paged pool holding the same tokens in shuffled blocks."""
    cfg, jcfg, params, jp = _arch(arch)
    atol = _atol(cfg)
    b = _batch(cfg)
    if kind == "train":
        with torch.no_grad():
            mine = forward(params, cfg, _to(b, "torch"), mode="train")
            diff = forward(params, cfg, _to(b, "torch"), mode="train",
                           differentiable=True)
        want = np.asarray(jax_forward(jp, jcfg, _to(b, "jax"),
                                      mode="train")["logits"])
        np.testing.assert_allclose(mine["logits"].numpy(), want, atol=atol,
                                   rtol=0)
        np.testing.assert_allclose(diff["logits"].numpy(), want, atol=atol,
                                   rtol=0)
        return
    W = 128
    last = np.asarray([99, 69], np.int32)
    with torch.no_grad():
        pre = forward(params, cfg, _to(b, "torch"), mode="prefill",
                      cache_width=W, last_index=torch.from_numpy(last))
    jpre = jax_forward(jp, jcfg, _to(b, "jax"), mode="prefill",
                       cache_width=W, last_index=jnp.asarray(last))
    if kind == "prefill":
        np.testing.assert_allclose(pre["logits"].numpy(),
                                   np.asarray(jpre["logits"]), atol=atol,
                                   rtol=0)
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
    rng = np.random.default_rng(9)
    step = last + 1
    for i in range(3):
        tok = rng.integers(3, cfg.vocab_size, (2, 1)).astype(np.int32)
        db = {"tokens": tok}
        if cfg.age_encoding:
            db["ages"] = np.full((2, 1), 84.5 + i, np.float32)
        with torch.no_grad():
            d = decode_step(params, cfg, cache, _to(db, "torch"),
                            torch.from_numpy(step))
        jd = jax_decode_step(jp, jcfg, jcache, _to(db, "jax"),
                             jnp.asarray(step))
        jcache = jd["cache"]
        np.testing.assert_allclose(d["logits"].numpy(),
                                   np.asarray(jd["logits"]), atol=atol,
                                   rtol=0)
        step = step + 1


def test_window_bites_on_reduced_danube():
    """The reduced Danube's window of 64 changes the logits of a 100-token
    history (the parity above would pass vacuously otherwise)."""
    cfg, _, params, _ = _arch("h2o-danube-1.8b")
    b = _to(_batch(cfg), "torch")
    with torch.no_grad():
        a = forward(params, cfg, b, mode="prefill")["logits"]
        c = forward(params, cfg.replace(sliding_window=None), b,
                    mode="prefill")["logits"]
    assert (a - c).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# the bridge, the registry and the checkpoint config
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_bridge_round_trip_new_archs(arch, tmp_path):
    """JAX ``init_params`` -> flat npz -> the port -> npz, exactly; and the
    port's ``init_params`` has JAX's keys and shapes."""
    jcfg = jax_config(arch, reduced=True).replace(dtype="float32")
    cfg = get_config(arch, reduced=True).replace(dtype="float32")
    flat = jax_flat(jax_init_params(jcfg, jax.random.PRNGKey(2)))
    path = tmp_path / "params.npz"
    np.savez(path, **flat)
    with np.load(path) as data:
        params = from_jax_flat({k: data[k] for k in data.files}, cfg,
                               device="cpu")
    back = to_flat_numpy(params)
    assert set(back) == set(flat)
    for k in flat:
        assert back[k].dtype == np.float32 and (back[k] == flat[k]).all(), k
    mine = init_params(cfg, seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: v.shape for k, v in flat.items()}


def test_registry_and_refusals():
    assert sorted(ALL_ARCHS) == sorted(
        ["delphi-2m", "delphi-100m", "mamba2-780m", "tinyllama-1.1b",
         "h2o-danube-1.8b", "qwen2.5-32b", "deepseek-7b", "zamba2-1.2b",
         "olmoe-1b-7b", "qwen2-moe-a2.7b", "internvl2-26b",
         "seamless-m4t-large-v2"])
    # a stand-in for the parameters: make_decode_cache reads their device
    stub = {"embed/embed": torch.zeros(1)}
    for arch in ALL_ARCHS:
        full, red = get_config(arch), get_config(arch, reduced=True)
        jfull, jred = jax_config(arch), jax_config(arch, reduced=True)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab_size", "qkv_bias", "norm", "activation",
                  "rope_theta", "max_seq_len", "tie_embeddings",
                  "sliding_window", "age_encoding", "dual_head", "citation",
                  "ssm_state", "ssm_expand", "ssm_head_dim", "ssm_conv",
                  "ssm_chunk", "attn_every", "n_experts", "top_k",
                  "n_shared_experts", "moe_d_ff", "router_aux_coef",
                  "n_encoder_layers", "enc_len_ratio", "dec_enc_len",
                  "frontend", "n_frontend_tokens"):
            assert getattr(full, f) == getattr(jfull, f), (arch, f)
            assert getattr(red, f) == getattr(jred, f), (arch, f)
        assert make_decode_cache(stub, red, 1, 8)
    dan = get_config("h2o-danube-1.8b", reduced=True)
    assert dan.sliding_window == 64 and dan.q_per_kv == 4
    assert get_config("tinyllama-1.1b", reduced=True).q_per_kv == 4
    zam = get_config("zamba2-1.2b", reduced=True)
    assert (zam.arch_type, zam.attn_every, zam.n_layers) == ("hybrid", 1, 2)
    base = get_config("tinyllama-1.1b", reduced=True)
    # every arch type is served: the hybrid, MoE (tests/test_torch_moe.py),
    # the VLM (tests/test_torch_vlm.py) and the encoder-decoders
    # (tests/test_torch_encdec.py); each builds its decode cache
    kinds = {"hybrid": dict(attn_every=1, ssm_state=16),
             "moe": dict(n_experts=4, top_k=2, moe_d_ff=128),
             "vlm": dict(frontend="vision_patches"),
             "audio": dict(n_encoder_layers=2, dec_enc_len=16),
             "enc_dec": dict(n_encoder_layers=2, dec_enc_len=16),
             "dense": {}, "ssm": dict(ssm_state=16)}
    want = {"hybrid": {"ssm", "attn"}, "ssm": {"ssm"},
            "audio": {"self", "cross"}, "enc_dec": {"self", "cross"}}
    for t, kw in kinds.items():
        cache = make_decode_cache(stub, base.replace(arch_type=t, **kw), 1, 8)
        assert set(cache) == want.get(t, {"self"}), t
    # an MoE config with no experts, which JAX's config lets through, and
    # an unknown arch type are refused where they are made
    with pytest.raises(ValueError, match="n_experts"):
        base.replace(arch_type="moe")
    with pytest.raises(ValueError, match="arch_type"):
        base.replace(arch_type="seq2seq")


def test_load_config_keeps_rope_theta(tmp_path):
    """A Qwen2.5 checkpoint written by the JAX package loads with its
    theta of 10^6 (the field used to be dropped without a word)."""
    jcfg = jax_config("qwen2.5-32b", reduced=True)
    jax_ckpt.save(str(tmp_path), {"w": jnp.zeros(2)}, jcfg)
    cfg, _ = checkpoint.load_config(str(tmp_path))
    assert cfg.rope_theta == 1e6 and cfg.qkv_bias and cfg.n_kv_heads == 1
    checkpoint.save(str(tmp_path / "port"), {}, cfg)
    jback, _ = jax_ckpt.load_config(str(tmp_path / "port"))
    assert jback.rope_theta == 1e6
