"""Model entry points: prefill, decode and the cache helpers of the serving
engine (the JAX package's ``models/model.py``) for every family.

Parameters are the flat dict of ``models.params``; layer ``l`` of a stacked
leaf is ``params[key][l]``.

* Dense (``arch_type="dense"``): pre-norm attention and MLP blocks, then
  the head.  Delphi (LayerNorm, GELU, tied head with the fp32
  ``out_bias``) takes no RoPE: its continuous age encoding replaces
  positions.  The generic dense LMs (TinyLlama, H2O-Danube, Qwen2.5,
  DeepSeek) take RoPE on q and k at absolute positions (``use_rope = not
  cfg.age_encoding``, as JAX), GQA, RMSNorm, a SwiGLU MLP, an untied head
  and, where configured, QKV biases and a sliding window.  Prefill
  attention runs the flash kernel; decode runs the paged decode kernel
  over the ring cache or the paged pool (``models.attention``).  Cache:
  ``{"self": LayerCache}``.  The suffix prefill of chunked admission
  (:func:`forward_suffix`) runs the flash kernel with position masks over
  context gathered from a paged pool.
* MoE (``arch_type="moe"``: OLMoE, Qwen2-MoE): the dense LMs' block with
  its MLP replaced by the experts (``models.moe.apply_moe``: an fp32
  top-k router, all experts over every token as batched products, the
  shared experts where configured).  Attention, caches and kernels are
  the dense family's (the "attention stack": DENSE or MOE); ``forward``
  returns the router's aux loss summed over the layers (0 for the other
  families).
* Mamba2 (``arch_type="ssm"``): pre-RMSNorm Mamba2 blocks
  (``models.ssm``; prefill's intra-chunk SSD runs the ``ssd_intra``
  kernel), then the untied head.  Cache: ``{"ssm": SSMCache}``.
* Zamba2 (``arch_type="hybrid"``): Mamba2's stack, with one weight-shared
  transformer block (``shared_attn/*``) applied before every
  ``cfg.attn_every``-th Mamba layer (:func:`n_attn_apps` applications,
  each at the same absolute positions, RoPE included).  Cache:
  ``{"ssm": SSMCache (L, ...), "attn": LayerCache (n_apps, ...)}``: one
  ring per application, indexed by ``layer // attn_every``.
* VLM (``arch_type="vlm"``: InternVL2): the dense LMs' stack over the
  batch's ``patches`` (B, n_frontend_tokens, d), cast to the activation
  dtype and put before the text embeddings; positions run over patches
  and text, so text position p is absolute position ``text_offset + p``
  (``forward`` returns ``text_offset``; ``last_index`` counts text tokens;
  a decode step is the absolute position).  Cache: ``{"self":
  LayerCache}`` over both.
* Encoder-decoder (``arch_type="audio"`` or ``"enc_dec"``: SeamlessM4T):
  the encoder runs its own stack (``encoder/*``) over the batch's
  ``frames`` (B, M, d) bidirectionally, with RoPE at frame positions
  0..M-1, then ``enc_norm``; each decoder block takes, between its causal
  self-attention and its MLP, a pre-norm cross-attention to that memory
  (q from the decoder, k and v from the memory, no RoPE, every key
  visible).  Cache: ``{"self": LayerCache, "cross": LayerCache}``, the
  cross rings holding the memory's K/V at positions 0..M-1, read by decode
  and never written.

Training (``forward(..., differentiable=True)``) takes plain torch ops in
every family: ``attention.chunked_attention`` for attention (causal or
not) and the plain SSD route of ``ssm.ssd_chunked`` for Mamba2 layers,
and the MoE routers and experts as serving runs them; no kernel has a
backward.  With ``cfg.remat`` each layer of that route (decoder, encoder,
Mamba2 and shared-block applications) runs under
``torch.utils.checkpoint`` (non-reentrant): its activations are
recomputed in the backward instead of kept, as the JAX package's
``_maybe_remat`` does; the serving routes ignore it.

``moe_impl`` (``forward``, ``forward_suffix``, ``decode_step``) picks the
MoE layers' dispatch, ``models.moe.apply_moe``'s ``impl``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs import base as cb
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import LayerCache, PagedCache
from repro_torch.models.layers import (act_dtype, age_encoding, apply_mlp,
                                       apply_norm, apply_rope, apply_swiglu,
                                       embed_tokens, logits_head,
                                       untied_logits_head)
from repro_torch.models.params import MATMUL_KEYS, Params
from repro_torch.models.ssm import SSMCache

# the decoder-only families whose layers are transformer blocks with a KV
# cache a layer
ATTENTION_STACKS = (cb.DENSE, cb.MOE, cb.VLM)
# the encoder-decoder families: a decoder block also cross-attends
ENC_DEC_STACKS = (cb.AUDIO, cb.ENC_DEC)


def cast_params(params: Params, cfg: ModelConfig) -> Params:
    """The same parameters with the matrix-product weights cast once to the
    activation dtype (what every forward would cast at use); the hybrid's
    shared block casts as a stacked layer does.  Leaves already in the
    activation dtype (``params.init_params_on_device``) are returned as
    they are, not copied."""
    dt = act_dtype(cfg)
    return {k: (v.to(dt) if k.replace("shared_attn/", "layers/", 1)
                in MATMUL_KEYS else v)
            for k, v in params.items()}


def _embed(params: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    x = embed_tokens(params["embed/embed"], batch["tokens"], act_dtype(cfg))
    if cfg.age_encoding:
        x = x + age_encoding(batch["ages"], cfg.d_model).to(x.dtype)
    return x


def _embed_input(params: Params, cfg: ModelConfig, batch):
    """(x (B, S', d), text_offset): the tokens' embeddings, after a VLM's
    ``patches`` (B, P, d) cast to the activation dtype (S' = P + S,
    text_offset = P), else alone (text_offset 0)."""
    x = _embed(params, cfg, batch)
    if cfg.frontend != "vision_patches":
        return x, 0
    patches = batch["patches"].to(x.dtype)
    return torch.cat([patches, x], dim=1), patches.shape[1]


def n_attn_apps(cfg: ModelConfig) -> int:
    """Hybrid: applications of the shared block over the layer stack."""
    return -(-cfg.n_layers // cfg.attn_every)


class Block:
    """One transformer block's weights by their name inside the block
    (``"attn/wq"``, ``"mlp_norm/scale"``, ...): layer ``l`` of the stacked
    ``layers/*`` leaves, or, with ``l=None``, the hybrid's unstacked
    ``shared_attn/*`` leaves, which every application reuses."""
    __slots__ = ("params", "prefix", "l")

    def __init__(self, params: Params, prefix: str = "layers/",
                 l: Optional[int] = None):
        self.params, self.prefix, self.l = params, prefix, l

    def __getitem__(self, name: str) -> torch.Tensor:
        leaf = self.params[self.prefix + name]
        return leaf if self.l is None else leaf[self.l]

    def __contains__(self, name: str) -> bool:
        return self.prefix + name in self.params

    def get(self, name: str) -> Optional[torch.Tensor]:
        """The tensor, or None where the config has none."""
        return self[name] if name in self else None


def _remat(fn, cfg: ModelConfig, differentiable: bool):
    """``fn``, or with ``cfg.remat`` on the training route ``fn`` under a
    non-reentrant activation checkpoint (recomputed in the backward)."""
    if not (cfg.remat and differentiable):
        return fn

    def checkpointed(*args, **kwargs):
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False,
                                                 **kwargs)
    return checkpointed


def _mlp_block(blk: Block, x: torch.Tensor, cfg: ModelConfig,
               moe_impl: str = "dense_scan"):
    """``x + MLP(norm(x))`` and the block's router aux loss (an fp32
    scalar for an MoE block, else None): the experts (dispatched by
    ``moe_impl``) where the block has a router, else SwiGLU or GELU."""
    h = apply_norm(x, blk["mlp_norm/scale"], blk.get("mlp_norm/bias"))
    if "moe/router" in blk:
        y, aux = moe_lib.apply_moe(blk, h, cfg, impl=moe_impl)
        return x + y, aux
    if "mlp/w_gate" in blk:
        return x + apply_swiglu(h, blk["mlp/w_gate"], blk["mlp/w_up"],
                                blk["mlp/w_down"]), None
    return x + apply_mlp(h, blk["mlp/w_fc"], blk["mlp/b_fc"],
                         blk["mlp/w_proj"], blk["mlp/b_proj"]), None


def _head(params: Params, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(x, params["final_norm/scale"], params.get("final_norm/bias"))
    if "embed/lm_head" in params:
        return untied_logits_head(params["embed/lm_head"], x,
                                  params.get("embed/out_bias"))
    return logits_head(params["embed/embed"], x, params.get("embed/out_bias"))


def mamba_layer(params: Params, x: torch.Tensor, cfg: ModelConfig, l: int, *,
                mode: str, cache: Optional[SSMCache] = None,
                differentiable: bool = False,
                last_index: Optional[torch.Tensor] = None):
    """Layer ``l``: ``x + Mamba2(RMSNorm(x))``.  mode "train" returns the
    new x (``differentiable`` takes the plain SSD route); "prefill" (x,
    (h, conv)) of this layer, the state at ``last_index`` (B,) where given
    (``ssm.ssm_forward``'s masked prefill); "decode" updates layer ``l`` of
    ``cache`` in place and returns the new x."""
    blk = Block(params, "layers/", l)
    h = apply_norm(x, blk["norm/scale"], blk.get("norm/bias"))
    p = ssm_lib.layer_params(params, l)
    if mode == "decode":
        y, hs, conv = ssm_lib.ssm_decode_step(p, h, cache.h[l], cache.conv[l],
                                              cfg)
        cache.h[l] = hs
        cache.conv[l] = conv
        return x + y
    if mode == "prefill":
        y, state = ssm_lib.ssm_forward(p, h, cfg, return_state=True,
                                       last_index=last_index)
        return x + y, state
    return x + ssm_lib.ssm_forward(p, h, cfg, differentiable=differentiable)


def _qkv(blk: Block, cfg: ModelConfig, x: torch.Tensor,
         positions: torch.Tensor):
    """A block's pre-norm and QKV projection (with its biases); with RoPE
    (``not cfg.age_encoding``) q and k are rotated at the absolute
    ``positions`` (broadcastable to (B, S)) before any cache write."""
    h = apply_norm(x, blk["attn_norm/scale"], blk.get("attn_norm/bias"))
    q, k, v = attn.project_qkv(h, blk["attn/wq"], blk["attn/wk"],
                               blk["attn/wv"], blk.get("attn/bq"),
                               blk.get("attn/bk"), blk.get("attn/bv"))
    if not cfg.age_encoding:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_block(blk: Block, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, differentiable: bool, *,
                causal: bool = True, memory: Optional[torch.Tensor] = None,
                moe_impl: str = "dense_scan"):
    """A whole pre-norm transformer block over a full sequence: causal
    attention within the config's window (or, with ``causal=False``,
    bidirectional: the encoder's), with ``memory`` (B, M, d) a
    cross-attention to it, then the MLP; each attention through the flash
    kernel, or ``chunked_attention`` on the training route.  Returns (x, k,
    v, aux, cross): k and v for a prefill's ring, aux the MLP's router loss
    (None without a router), cross the memory's (k, v) for a prefill's
    cross ring (None without ``memory``)."""
    q, k, v = _qkv(blk, cfg, x, positions)
    window = cfg.sliding_window if causal else None
    if differentiable:
        o = attn.chunked_attention(q, k, v, positions, positions,
                                   causal=causal, window=window,
                                   q_per_kv=cfg.q_per_kv)
    elif causal:
        o = attn.prefill_attention(q, k, v, window=window)
    else:
        o = attn.full_attention(q, k, v)
    x = x + attn.output_projection(o, blk["attn/wo"])
    cross = None
    if memory is not None:
        x, cross = _cross_block(blk, cfg, x, memory, differentiable)
    x, aux = _mlp_block(blk, x, cfg, moe_impl)
    return x, k, v, aux, cross


def _cross_block(blk: Block, cfg: ModelConfig, x: torch.Tensor,
                 memory: torch.Tensor, differentiable: bool):
    """``x + CrossAttn(cross_norm(x), memory)``: q from x, k and v from the
    memory (B, M, d), no RoPE, every key visible (T = M keys for S
    queries).  Returns (x, (k, v))."""
    h = apply_norm(x, blk["cross_norm/scale"], blk.get("cross_norm/bias"))
    q, k, v = attn.project_qkv(h, blk["cross_attn/wq"], blk["cross_attn/wk"],
                               blk["cross_attn/wv"], blk.get("cross_attn/bq"),
                               blk.get("cross_attn/bk"),
                               blk.get("cross_attn/bv"), xkv=memory)
    if differentiable:
        qpos = torch.arange(x.shape[1], device=x.device)
        mpos = torch.arange(memory.shape[1], device=x.device)
        o = attn.chunked_attention(q, k, v, qpos, mpos, causal=False,
                                   q_per_kv=cfg.q_per_kv)
    else:
        o = attn.full_attention(q, k, v)
    return x + attn.output_projection(o, blk["cross_attn/wo"]), (k, v)


def _encode(params: Params, cfg: ModelConfig, frames: torch.Tensor,
            differentiable: bool) -> torch.Tensor:
    """The encoder's memory (B, M, d): frame embeddings (B, M, d), cast to
    the activation dtype, through the ``encoder/*`` blocks bidirectionally
    (RoPE at frame positions 0..M-1, as every self-attention of a config
    without age encoding), then ``enc_norm``."""
    x = frames.to(act_dtype(cfg))
    B, M = x.shape[:2]
    fpos = torch.arange(M, dtype=torch.int32, device=x.device).expand(B, M)
    block = _remat(_attn_block, cfg, differentiable)
    for l in range(cfg.n_encoder_layers):
        x = block(Block(params, "encoder/", l), cfg, x, fpos,
                  differentiable, causal=False)[0]
    return apply_norm(x, params["enc_norm/scale"], params.get("enc_norm/bias"))


def _cross_decode(blk: Block, cfg: ModelConfig, x: torch.Tensor,
                  cross: LayerCache, l: int, table: torch.Tensor):
    """Decode's ``x + CrossAttn(cross_norm(x))`` against layer ``l``'s
    cross ring, which it does not write."""
    h = apply_norm(x, blk["cross_norm/scale"], blk.get("cross_norm/bias"))
    q = attn.project_q(h, blk["cross_attn/wq"], blk.get("cross_attn/bq"))
    o = attn.cross_decode_attention(q, cross, l, table)
    return x + attn.output_projection(o, blk["cross_attn/wo"])


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, Any], *,
            mode: str = "train", cache_width: Optional[int] = None,
            last_index: Optional[torch.Tensor] = None,
            differentiable: bool = False,
            moe_impl: str = "dense_scan") -> Dict[str, Any]:
    """mode "train": (B, S, V) fp32 logits at every position.  With
    ``differentiable=True`` (mode "train" only) the forward takes plain
    torch ops that autograd can go through (the training route; the
    kernels have no backward): attention by
    :func:`~repro_torch.models.attention.chunked_attention` instead of the
    flash kernel, and Mamba2 layers by the plain SSD route instead of the
    ``ssd_intra`` kernel.
    mode "prefill": logits (B, 1, V) at ``last_index`` (B,) — each row's
    last valid text token of a right-padded batch — or at the last
    position, plus ``cache``: {"self": LayerCache} rings of width
    ``cache_width`` (default: the window where the config has one, else
    S', as JAX), {"ssm": SSMCache} (Mamba2: the state at ``last_index``,
    its padding masked by ``dt = 0``, or after the whole sequence without
    it), both kinds for the hybrid ({"ssm", "attn"}: one ring per
    application of the shared block), or for an encoder-decoder {"self",
    "cross"} (the cross rings M wide).  Both modes return ``aux_loss``:
    the MoE routers' load-balance losses summed over the layers (an fp32
    scalar, 0 for the other families), and ``text_offset``: the number of
    patch positions before the text (0 but for a VLM), as the JAX
    package's ``forward``.  ``moe_impl`` picks the MoE dispatch; with
    ``cfg.remat`` the training route checkpoints each layer.

    batch: tokens (B, S) int; for Delphi ages (B, S) float years; for a
    VLM patches (B, n_frontend_tokens, d); for an encoder-decoder frames
    (B, M, d)."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode must be 'train' or 'prefill': {mode!r}")
    if differentiable and mode != "train":
        raise ValueError("differentiable=True is the training route: "
                         "mode 'train' only")
    x, offset = _embed_input(params, cfg, batch)
    B, S = x.shape[:2]
    out: Dict[str, Any] = {"text_offset": offset}
    prefill = mode == "prefill"
    t = cfg.arch_type
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    cache, ssm_cache, cross = None, None, None
    enc_dec = t in ENC_DEC_STACKS
    stack = t in ATTENTION_STACKS or enc_dec
    memory = (_encode(params, cfg, batch["frames"], differentiable)
              if enc_dec else None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if prefill and t != cb.SSM:
        win = cfg.sliding_window
        W = cache_width or (win if win is not None else S)
        n = cfg.n_layers if stack else n_attn_apps(cfg)
        cache = attn.empty_cache(n, B, cfg.n_kv_heads, W, cfg.head_dim,
                                 x.dtype, x.device)
        if enc_dec:
            M = memory.shape[1]
            cross = attn.empty_cache(n, B, cfg.n_kv_heads, M, cfg.head_dim,
                                     x.dtype, x.device)
            mpos = torch.arange(M, dtype=torch.int32,
                                device=x.device).expand(B, M)

    def fill(rings: LayerCache, i: int, k, v, pos):
        ring = attn.cache_from_prefill(k, v, pos, rings.k.shape[3])
        rings.k[i] = ring.k
        rings.v[i] = ring.v
        rings.pos[i] = ring.pos

    block = _remat(_attn_block, cfg, differentiable)
    mamba = _remat(mamba_layer, cfg, differentiable)

    def attend(blk: Block, x, i: int):
        """Block ``blk`` over x; a prefill writes its ring ``i`` (and its
        cross ring ``i``)."""
        nonlocal aux
        x, k, v, a, kv = block(blk, cfg, x, positions, differentiable,
                               memory=memory, moe_impl=moe_impl)
        if a is not None:
            aux = aux + a
        if cache is not None:
            fill(cache, i, k, v, positions)
        if cross is not None:
            fill(cross, i, *kv, mpos)
        return x
    if stack:
        for l in range(cfg.n_layers):
            x = attend(Block(params, "layers/", l), x, l)
    else:
        shared = Block(params, "shared_attn/")
        hs, convs = [], []
        for l in range(cfg.n_layers):
            if t == cb.HYBRID and l % cfg.attn_every == 0:
                x = attend(shared, x, l // cfg.attn_every)
            if prefill:
                x, (h, conv) = mamba_layer(params, x, cfg, l, mode="prefill",
                                           last_index=last_index)
                hs.append(h)
                convs.append(conv)
            else:
                x = mamba(params, x, cfg, l, mode="train",
                          differentiable=differentiable)
        if prefill:
            ssm_cache = SSMCache(h=torch.stack(hs), conv=torch.stack(convs))
    if prefill:
        x = _last_rows(x, None if last_index is None
                       else last_index + offset)
        out["cache"] = ({"self": cache, "cross": cross} if enc_dec else
                        {"self": cache} if stack else
                        {"ssm": ssm_cache} if t == cb.SSM else
                        {"ssm": ssm_cache, "attn": cache})
    out["logits"] = _head(params, x)
    out["aux_loss"] = aux
    return out


def forward_suffix(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
                   ctx: Dict[str, torch.Tensor], *,
                   last_index: torch.Tensor,
                   moe_impl: str = "dense_scan") -> Dict[str, Any]:
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
    architectures only, as :func:`make_paged_decode_cache` (a VLM's
    chunk is text: the patches sit in the context, as JAX's)."""
    if cfg.arch_type not in ATTENTION_STACKS:
        raise ValueError(f"suffix prefill supports attention-cache "
                         f"architectures (dense/moe/vlm), not "
                         f"{cfg.arch_type}")
    x = _embed(params, cfg, batch)
    positions = batch["positions"]
    ks, vs = [], []
    for l in range(cfg.n_layers):
        # RoPE at the chunk's absolute positions: its K is byte-compatible
        # with the cached context's
        blk = Block(params, "layers/", l)
        q, k, v = _qkv(blk, cfg, x, positions)
        o = attn.suffix_attention(q, k, v, ctx["k"][l], ctx["v"][l],
                                  positions, ctx["pos"],
                                  window=cfg.sliding_window)
        x = x + attn.output_projection(o, blk["attn/wo"])
        x, _ = _mlp_block(blk, x, cfg, moe_impl)
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
                step, *, moe_impl: str = "dense_scan") -> Dict[str, Any]:
    """One-token decode.  batch: tokens (B, 1), and for Delphi ages (B, 1);
    ``step``: (B,) absolute position of each row's new token (or one int
    for all rows; the SSM state does not read it; a VLM's counts the
    patches: ``text_offset`` + the text position).  The cache is updated
    in place (and returned as ``cache``); an encoder-decoder's cross rings
    are read, not written.  Returns {"logits": (B, 1, V) fp32, "cache":
    cache}."""
    x = _embed(params, cfg, batch)
    t = cfg.arch_type
    if t == cb.SSM:
        sc: SSMCache = cache["ssm"]
        for l in range(cfg.n_layers):
            x = mamba_layer(params, x, cfg, l, mode="decode", cache=sc)
        return {"logits": _head(params, x), "cache": cache}
    B = x.shape[0]
    step = torch.as_tensor(step, dtype=torch.int32, device=x.device)
    if step.dim() == 0:
        step = step.expand(B)
    stack = t in ATTENTION_STACKS or t in ENC_DEC_STACKS
    lc = cache["self"] if stack else cache["attn"]
    cross = cache.get("cross")
    rows = torch.arange(B, dtype=torch.int32, device=x.device)[:, None]
    win = cfg.sliding_window
    if isinstance(lc, PagedCache):
        # one position write a tick for all layers; per layer the pool
        # write, then the kernel through the slots' tables
        dst, off = attn.write_paged_positions(lc, step)

        def attend(q, k, v, l):
            return attn.paged_decode_layer_attention(q, k, v, lc, l, dst,
                                                     off, step, window=win)
    else:
        # one position write a tick for every ring (a layer's, or a shared
        # block application's)
        slot = attn.write_ring_positions(lc, step)

        def attend(q, k, v, l):
            return attn.ring_decode_attention(q, k, v, lc, l, slot, step,
                                              rows, window=win)
    pos1 = step[:, None]                # each row's own position (B, 1)

    def block(blk: Block, x, i: int):
        q, k, v = _qkv(blk, cfg, x, pos1)
        o = attend(q, k, v, i)
        x = x + attn.output_projection(o, blk["attn/wo"])
        if cross is not None:
            x = _cross_decode(blk, cfg, x, cross, i, rows)
        return _mlp_block(blk, x, cfg, moe_impl)[0]
    if stack:
        for l in range(cfg.n_layers):
            x = block(Block(params, "layers/", l), x, l)
    else:
        shared = Block(params, "shared_attn/")
        sc = cache["ssm"]
        for l in range(cfg.n_layers):
            if l % cfg.attn_every == 0:
                # the application's ring, not the Mamba layer's index
                x = block(shared, x, l // cfg.attn_every)
            x = mamba_layer(params, x, cfg, l, mode="decode", cache=sc)
    return {"logits": _head(params, x), "cache": cache}


def mask_padded_positions(cache, last_idx: torch.Tensor):
    """Invalidate ring positions past each row's true last token (right-
    padded batched prefill wrote garbage K/V there): pos -> -1 until decode
    writes reclaim the slots.  ``last_idx`` (B,) int is an absolute
    position (a VLM's counts its patches).  SSM state passes through
    unchanged (``forward``'s prefill already masked it at ``last_index``),
    and so do an encoder-decoder's cross rings: their positions are the
    memory's, not the decoder's (the JAX package's function masks every
    ring it is given, the cross ones too, which no caller of the reference
    reaches).  last_idx: (B,) int."""
    li = last_idx.reshape(1, -1, 1).to(torch.int32)

    def fix(k, v):
        if isinstance(v, LayerCache) and k != "cross":
            return v._replace(pos=torch.where((v.pos >= 0) & (v.pos <= li),
                                              v.pos,
                                              torch.full_like(v.pos, -1)))
        return v
    return {k: fix(k, v) for k, v in cache.items()}


def ring_width(cfg: ModelConfig, context_len: int) -> int:
    """The decode ring's width: ``context_len``, or the sliding window
    where it is narrower (older tokens are masked out by the window, so a
    wider ring would only hold them), as the JAX package's
    ``make_decode_cache``."""
    return min(cfg.sliding_window or context_len, context_len)


def make_decode_cache(params: Params, cfg: ModelConfig, batch: int,
                      context_len: int):
    """An empty decode cache for ``batch`` slots on the parameters' device:
    a ring of :func:`ring_width` per layer in the activation dtype (dense,
    MoE, VLM; an encoder-decoder also a cross ring of ``dec_enc_len`` per
    layer), Mamba2's constant-size state (fp32 ``h``, conv inputs in the
    activation dtype), which does not depend on ``context_len``, or the
    hybrid's state per Mamba layer and ring per shared-block
    application."""
    device = params["embed/embed"].device
    dt = act_dtype(cfg)
    W = ring_width(cfg, context_len)

    def rings(width: int) -> LayerCache:
        return attn.empty_cache(cfg.n_layers, batch, cfg.n_kv_heads, width,
                                cfg.head_dim, dt, device)
    if cfg.arch_type in ATTENTION_STACKS:
        return {"self": rings(W)}
    if cfg.arch_type in ENC_DEC_STACKS:
        return {"self": rings(W), "cross": rings(cfg.dec_enc_len)}
    out = {"ssm": ssm_lib.empty_ssm_cache(cfg, cfg.n_layers, batch, dt,
                                          device)}
    if cfg.arch_type == cb.HYBRID:
        out["attn"] = attn.empty_cache(n_attn_apps(cfg), batch,
                                       cfg.n_kv_heads, W, cfg.head_dim, dt,
                                       device)
    return out


def make_paged_decode_cache(params: Params, cfg: ModelConfig, batch: int,
                            context_len: int, *, num_blocks: int,
                            block_size: int):
    """The paged twin of :func:`make_decode_cache`: a pool of
    ``num_blocks`` blocks of ``block_size`` tokens (block 0 is the trash
    block) and all-unallocated tables of ``context_len / block_size``
    entries for ``batch`` slots.  Attention caches only: a recurrent
    state has nothing to page, and an encoder-decoder's cross rings are
    not paged (as JAX)."""
    if cfg.arch_type not in ATTENTION_STACKS:
        raise ValueError(f"paged KV cache supports attention-cache "
                         f"architectures (dense/moe/vlm), not "
                         f"{cfg.arch_type}")
    return {"self": attn.empty_paged_cache(
        cfg.n_layers, num_blocks, batch, cfg.n_kv_heads, context_len,
        block_size, cfg.head_dim, act_dtype(cfg),
        params["embed/embed"].device)}


def param_count(params: Params) -> int:
    return sum(int(v.numel()) for v in params.values())
