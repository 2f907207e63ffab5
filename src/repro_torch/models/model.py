"""Model entry points: prefill, decode and the cache helpers of the serving
engine (the JAX package's ``models/model.py``) for two families.

Parameters are the flat dict of ``models.params``; layer ``l`` of a stacked
leaf is ``params[key][l]``.

* Delphi (``arch_type="dense"``): pre-LayerNorm attention (no RoPE:
  Delphi's continuous age encoding replaces positions) and a GELU MLP,
  then the tied head with the fp32 ``out_bias``.  Prefill attention runs
  the flash kernel; decode runs the paged decode kernel over the ring cache
  (``models.attention``).  Cache: ``{"self": LayerCache}``.  The suffix
  prefill of chunked admission (:func:`forward_suffix`) runs the flash
  kernel with position masks over context gathered from a paged pool.
* Mamba2 (``arch_type="ssm"``): pre-RMSNorm Mamba2 blocks
  (``models.ssm``; prefill's intra-chunk SSD runs the ``ssd_intra``
  kernel), then the untied head.  Cache: ``{"ssm": SSMCache}``.

Dense configurations that need RoPE, GQA, SwiGLU, RMSNorm, a sliding
window, QKV biases or an untied head, and the other families (MoE, hybrid,
enc-dec, VLM, audio), raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs import base as cb
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import LayerCache, PagedCache
from repro_torch.models.layers import (act_dtype, age_encoding, apply_mlp,
                                       apply_norm, embed_tokens, logits_head,
                                       untied_logits_head)
from repro_torch.models.params import Params
from repro_torch.models.ssm import SSMCache

# weights that enter a matrix product or the activation-dtype conv (cast to
# the activation dtype); norms, out_bias, A_log, dt_bias, D and norm_scale
# are used in fp32
MATMUL_KEYS = ("embed/embed", "embed/lm_head", "layers/attn/wq",
               "layers/attn/wk", "layers/attn/wv", "layers/attn/wo",
               "layers/mlp/w_fc", "layers/mlp/b_fc", "layers/mlp/w_proj",
               "layers/mlp/b_proj", "layers/ssm/in_proj", "layers/ssm/conv_w",
               "layers/ssm/conv_b", "layers/ssm/out_proj")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this port does not serve."""
    if cfg.arch_type == cb.SSM:
        return
    gaps = []
    if cfg.arch_type != cb.DENSE:
        gaps.append(f"arch_type={cfg.arch_type}")
    if not cfg.age_encoding:
        gaps.append("RoPE (age_encoding=False)")
    if cfg.n_kv_heads != cfg.n_heads:
        gaps.append("GQA")
    if cfg.activation != "gelu":
        gaps.append(f"activation={cfg.activation}")
    if cfg.norm != "layernorm":
        gaps.append(f"norm={cfg.norm}")
    if cfg.sliding_window is not None:
        gaps.append("sliding window")
    if cfg.qkv_bias:
        gaps.append("qkv_bias")
    if not cfg.tie_embeddings:
        gaps.append("untied head")
    if gaps:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {', '.join(gaps)}")


def cast_params(params: Params, cfg: ModelConfig) -> Params:
    """The same parameters with the matrix-product weights cast once to the
    activation dtype (what every forward would cast at use)."""
    dt = act_dtype(cfg)
    return {k: (v.to(dt) if k in MATMUL_KEYS else v)
            for k, v in params.items()}


def _embed(params: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    x = embed_tokens(params["embed/embed"], batch["tokens"], act_dtype(cfg))
    if cfg.age_encoding:
        x = x + age_encoding(batch["ages"], cfg.d_model).to(x.dtype)
    return x


def _mlp_block(params: Params, x: torch.Tensor, l: int) -> torch.Tensor:
    h = apply_norm(x, params["layers/mlp_norm/scale"][l],
                   params["layers/mlp_norm/bias"][l])
    return x + apply_mlp(h, params["layers/mlp/w_fc"][l],
                         params["layers/mlp/b_fc"][l],
                         params["layers/mlp/w_proj"][l],
                         params["layers/mlp/b_proj"][l])


def _head(params: Params, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(x, params["final_norm/scale"], params.get("final_norm/bias"))
    if "embed/lm_head" in params:
        return untied_logits_head(params["embed/lm_head"], x)
    return logits_head(params["embed/embed"], x, params.get("embed/out_bias"))


def mamba_layer(params: Params, x: torch.Tensor, cfg: ModelConfig, l: int, *,
                mode: str, cache: Optional[SSMCache] = None):
    """Layer ``l``: ``x + Mamba2(RMSNorm(x))``.  mode "train" returns the
    new x; "prefill" (x, (h, conv)) of this layer; "decode" updates layer
    ``l`` of ``cache`` in place and returns the new x."""
    bias = params.get("layers/norm/bias")
    h = apply_norm(x, params["layers/norm/scale"][l],
                   None if bias is None else bias[l])
    p = ssm_lib.layer_params(params, l)
    if mode == "decode":
        y, hs, conv = ssm_lib.ssm_decode_step(p, h, cache.h[l], cache.conv[l],
                                              cfg)
        cache.h[l] = hs
        cache.conv[l] = conv
        return x + y
    if mode == "prefill":
        y, state = ssm_lib.ssm_forward(p, h, cfg, return_state=True)
        return x + y, state
    return x + ssm_lib.ssm_forward(p, h, cfg)


def _ssm_stack(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
               mode: str):
    """Prefill/train over the layer stack; prefill also returns the stacked
    :class:`SSMCache`."""
    if mode == "train":
        for l in range(cfg.n_layers):
            x = mamba_layer(params, x, cfg, l, mode="train")
        return x, None
    hs, convs = [], []
    for l in range(cfg.n_layers):
        x, (h, conv) = mamba_layer(params, x, cfg, l, mode="prefill")
        hs.append(h)
        convs.append(conv)
    return x, SSMCache(h=torch.stack(hs), conv=torch.stack(convs))


def _qkv(params: Params, x: torch.Tensor, l: int):
    h = apply_norm(x, params["layers/attn_norm/scale"][l],
                   params["layers/attn_norm/bias"][l])
    return attn.project_qkv(h, params["layers/attn/wq"][l],
                            params["layers/attn/wk"][l],
                            params["layers/attn/wv"][l])


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, Any], *,
            mode: str = "train", cache_width: Optional[int] = None,
            last_index: Optional[torch.Tensor] = None,
            differentiable: bool = False) -> Dict[str, Any]:
    """mode "train": (B, S, V) fp32 logits at every position.  With
    ``differentiable=True`` (mode "train" only) attention takes the plain
    :func:`~repro_torch.models.attention.chunked_attention` instead of the
    flash kernel, so the logits can be differentiated (the training route;
    the kernels have no backward).  Mamba2's differentiable route (the JAX
    package's ``ssd_chunked`` in plain ops) is not ported: it raises.
    mode "prefill": logits (B, 1, V) at ``last_index`` (B,) — each row's
    last valid token of a right-padded batch — or at the last position,
    plus ``cache``: {"self": LayerCache} rings of width ``cache_width``
    (Delphi) or {"ssm": SSMCache} (Mamba2: the state after the whole
    sequence, so its rows must not be right-padded).

    batch: tokens (B, S) int, and for Delphi ages (B, S) float years."""
    check_supported(cfg)
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode must be 'train' or 'prefill': {mode!r}")
    if differentiable:
        if mode != "train":
            raise ValueError("differentiable=True is the training route: "
                             "mode 'train' only")
        if cfg.arch_type == cb.SSM:
            raise NotImplementedError(
                f"{cfg.name}: training Mamba2 is not ported yet: its "
                f"differentiable route (the JAX package's ssd_chunked in "
                f"plain ops) is still to port, and the ssd_intra kernel "
                f"has no backward")
    x = _embed(params, cfg, batch)
    B, S = x.shape[:2]
    out: Dict[str, Any] = {}
    if cfg.arch_type == cb.SSM:
        x, ssm_cache = _ssm_stack(params, x, cfg, mode=mode)
        if mode == "prefill":
            x = _last_rows(x, last_index)
            out["cache"] = {"ssm": ssm_cache}
        out["logits"] = _head(params, x)
        return out
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    cache = None
    if mode == "prefill":
        W = cache_width or S
        cache = attn.empty_cache(cfg.n_layers, B, cfg.n_kv_heads, W,
                                 cfg.head_dim, x.dtype, x.device)
    for l in range(cfg.n_layers):
        q, k, v = _qkv(params, x, l)
        if differentiable:
            o = attn.chunked_attention(q, k, v, positions, positions,
                                       causal=True, window=cfg.sliding_window,
                                       q_per_kv=cfg.q_per_kv)
        else:
            o = attn.prefill_attention(q, k, v)
        x = x + attn.output_projection(o, params["layers/attn/wo"][l])
        x = _mlp_block(params, x, l)
        if cache is not None:
            ring = attn.cache_from_prefill(k, v, positions, cache.k.shape[3])
            cache.k[l] = ring.k
            cache.v[l] = ring.v
            cache.pos[l] = ring.pos
    if mode == "prefill":
        x = _last_rows(x, last_index)
        out["cache"] = {"self": cache}
    out["logits"] = _head(params, x)
    return out


def forward_suffix(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
                   ctx: Dict[str, torch.Tensor], *,
                   last_index: torch.Tensor) -> Dict[str, Any]:
    """Chunked-prefill forward over a prompt suffix: the chunk's tokens
    attend over context already in the cache (earlier chunks, or blocks
    lent by the prefix index) and over themselves, by absolute position.

    batch: tokens (B, Sc) int, for Delphi ages (B, Sc), positions (B, Sc)
    int32 absolute positions (-1 = right padding).  ctx: "k"/"v"
    (L, B, C, Hkv, hd) the context K/V per layer and "pos" (B, C) their
    positions (-1 = invalid), as ``attention.gather_context`` returns them.
    ``last_index`` (B,): each row's last valid chunk token, where the
    logits are read.

    Returns {"logits": (B, 1, V) fp32, "k"/"v": (L, B, Sc, Hkv, hd)}: the
    chunk's K/V for the caller's block write.  Attention-cache
    architectures only, as :func:`make_paged_decode_cache`."""
    if cfg.arch_type not in (cb.DENSE, cb.MOE, cb.VLM):
        raise ValueError(f"suffix prefill supports attention-cache "
                         f"architectures (dense/moe/vlm), not "
                         f"{cfg.arch_type}")
    check_supported(cfg)
    x = _embed(params, cfg, batch)
    positions = batch["positions"]
    ks, vs = [], []
    for l in range(cfg.n_layers):
        q, k, v = _qkv(params, x, l)
        o = attn.suffix_attention(q, k, v, ctx["k"][l], ctx["v"][l],
                                  positions, ctx["pos"])
        x = x + attn.output_projection(o, params["layers/attn/wo"][l])
        x = _mlp_block(params, x, l)
        ks.append(k)
        vs.append(v)
    x = _last_rows(x, last_index)
    return {"logits": _head(params, x), "k": torch.stack(ks),
            "v": torch.stack(vs)}


def _last_rows(x: torch.Tensor, last_index: Optional[torch.Tensor]):
    """(B, 1, d) rows at ``last_index`` (B,), or at the last position.  The
    decode bootstrap needs one position per row: gathering before the head
    keeps the (B, S, V) logits out of memory."""
    if last_index is None:
        return x[:, -1:]
    B = x.shape[0]
    idx = last_index.long().reshape(B, 1, 1).expand(B, 1, x.shape[2])
    return x.gather(1, idx)


def decode_step(params: Params, cfg: ModelConfig, cache, batch: Dict[str, Any],
                step) -> Dict[str, Any]:
    """One-token decode.  batch: tokens (B, 1), and for Delphi ages (B, 1);
    ``step``: (B,) absolute position of each row's new token (or one int
    for all rows; the SSM state does not read it).  The cache is updated in
    place (and returned as ``cache``).  Returns {"logits": (B, 1, V) fp32,
    "cache": cache}."""
    check_supported(cfg)
    x = _embed(params, cfg, batch)
    if cfg.arch_type == cb.SSM:
        sc: SSMCache = cache["ssm"]
        for l in range(cfg.n_layers):
            x = mamba_layer(params, x, cfg, l, mode="decode", cache=sc)
        return {"logits": _head(params, x), "cache": cache}
    B = x.shape[0]
    step = torch.as_tensor(step, dtype=torch.int32, device=x.device)
    if step.dim() == 0:
        step = step.expand(B)
    lc = cache["self"]
    if isinstance(lc, PagedCache):
        # one position write a tick for all layers; per layer the pool
        # write, then the kernel through the slots' tables
        dst, off = attn.write_paged_positions(lc, step)

        def attend(q, k, v, l):
            return attn.paged_decode_layer_attention(q, k, v, lc, l, dst,
                                                     off, step)
    else:
        slot = attn.write_ring_positions(lc, step)
        table = torch.arange(B, dtype=torch.int32, device=x.device)[:, None]

        def attend(q, k, v, l):
            return attn.ring_decode_attention(q, k, v, lc, l, slot, step,
                                              table)
    for l in range(cfg.n_layers):
        q, k, v = _qkv(params, x, l)
        o = attend(q, k, v, l)
        x = x + attn.output_projection(o, params["layers/attn/wo"][l])
        x = _mlp_block(params, x, l)
    return {"logits": _head(params, x), "cache": cache}


def mask_padded_positions(cache, last_idx: torch.Tensor):
    """Invalidate ring positions past each row's true last token (right-
    padded batched prefill wrote garbage K/V there): pos -> -1 until decode
    writes reclaim the slots.  SSM state passes through unchanged (the
    engine never right-pads a recurrent architecture).  last_idx: (B,) int."""
    li = last_idx.reshape(1, -1, 1).to(torch.int32)

    def fix(v):
        if isinstance(v, LayerCache):
            return v._replace(pos=torch.where((v.pos >= 0) & (v.pos <= li),
                                              v.pos,
                                              torch.full_like(v.pos, -1)))
        return v
    return {k: fix(v) for k, v in cache.items()}


def make_decode_cache(params: Params, cfg: ModelConfig, batch: int,
                      context_len: int):
    """An empty decode cache for ``batch`` slots on the parameters' device:
    Delphi's ring of width ``context_len`` in the activation dtype, or
    Mamba2's constant-size state (fp32 ``h``, conv inputs in the activation
    dtype), which does not depend on ``context_len``."""
    check_supported(cfg)
    device = params["embed/embed"].device
    if cfg.arch_type == cb.SSM:
        return {"ssm": ssm_lib.empty_ssm_cache(cfg, cfg.n_layers, batch,
                                               act_dtype(cfg), device)}
    return {"self": attn.empty_cache(cfg.n_layers, batch, cfg.n_kv_heads,
                                     context_len, cfg.head_dim,
                                     act_dtype(cfg), device)}


def make_paged_decode_cache(params: Params, cfg: ModelConfig, batch: int,
                            context_len: int, *, num_blocks: int,
                            block_size: int):
    """The paged twin of :func:`make_decode_cache`: a pool of
    ``num_blocks`` blocks of ``block_size`` tokens (block 0 is the trash
    block) and all-unallocated tables of ``context_len / block_size``
    entries for ``batch`` slots.  Attention caches only: a recurrent
    state has nothing to page."""
    if cfg.arch_type not in (cb.DENSE, cb.MOE, cb.VLM):
        raise ValueError(f"paged KV cache supports attention-cache "
                         f"architectures (dense/moe/vlm), not "
                         f"{cfg.arch_type}")
    check_supported(cfg)
    return {"self": attn.empty_paged_cache(
        cfg.n_layers, num_blocks, batch, cfg.n_kv_heads, context_len,
        block_size, cfg.head_dim, act_dtype(cfg),
        params["embed/embed"].device)}


def param_count(params: Params) -> int:
    return sum(int(v.numel()) for v in params.values())
