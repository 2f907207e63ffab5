"""Shared layers: norms, RoPE, continuous age encoding, the GELU and
SwiGLU MLPs, embedding and the tied and untied logits heads.

Compute runs in the activation dtype ``cfg.dtype``; parameters stay fp32
and are cast at use (``.to`` is a no-op for weights already cast by
``models.model.cast_params``).  Numerics follow the JAX package's
``models/layers.py``: norms in fp32 with population variance, the tanh
GELU, and heads whose product runs in the activation dtype before the
logits go to fp32 (and the fp32 ``out_bias`` is added).  RoPE rotates
in fp32 at absolute positions, split into halves (not interleaved).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import sharded
from repro_torch.configs.base import ModelConfig


def act_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def apply_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm (with ``bias``) or RMSNorm, computed in fp32 and cast back
    to x's dtype."""
    dt = x.dtype
    x32 = x.float()
    if bias is not None:
        mu = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mu).square().mean(dim=-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        y = y * scale.float() + bias.float()
    else:
        ms = x32.square().mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(ms + eps) * scale.float()
    return y.to(dt)


@functools.lru_cache(maxsize=None)
def _rope_table(half: int, theta: float, device: str) -> torch.Tensor:
    """The (half,) fp32 RoPE frequencies ``1 / theta ** (i / half)``, made
    once on the host and copied to ``device``.  Each step of the JAX
    package's fp32 chain (divide, power, reciprocal) is correctly rounded
    here, the power through fp64; the table then equals XLA's bit for bit
    (numpy's fp32 ``power`` is off by up to 2 ulps at a few entries, and
    near position 4,096 one ulp of the top frequency moves the angle by
    ~5e-4 rad)."""
    f32 = np.float32
    expo = np.arange(half, dtype=f32) / f32(half)
    power = (np.float64(f32(theta)) ** expo.astype(np.float64)).astype(f32)
    return torch.from_numpy(f32(1.0) / power).to(device)


def rope_frequencies(head_dim: int, theta: float,
                     device="cpu") -> torch.Tensor:
    """(head_dim // 2,) fp32 inverse frequencies of RoPE on ``device``."""
    # while torch.export traces, the table is made anew (it becomes one of
    # the graph's constants): the cache would keep the tracer's fake tensor
    table = (_rope_table.__wrapped__ if torch.compiler.is_exporting()
             else _rope_table)
    return table(head_dim // 2, float(theta), str(device))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: absolute positions broadcastable to
    (..., S).  Rotates the two halves of each head by ``positions *
    freqs`` in fp32 and casts back to x's dtype."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions.float()[..., None] * freqs          # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _inv_scales(half: int, min_scale: float, max_scale: float,
                device: str) -> torch.Tensor:
    """The (half,) fp32 frequency table of :func:`age_encoding`, made once
    on the host and copied to ``device``.

    The fp32 chain of the JAX package (``log``, divide, multiply by the
    index, ``exp``, scale) is kept, with each step correctly rounded, so the
    table is the same on every device.  It matters: at age 85 the top
    frequency's angle is ~8.5e4 rad, where one ulp of a frequency moves the
    angle by ~5e-3 rad.  XLA's fp32 ``exp`` is off by one ulp at a few
    entries, which is what bounds the logits' agreement with the JAX package
    (the tolerances of the port's tests are measured, not assumed)."""
    f32 = np.float32
    log_inc = f32(np.log(np.float64(f32(max_scale / min_scale)))) \
        / f32(max(half - 1, 1))
    arg = -log_inc * np.arange(half, dtype=f32)
    table = f32(1.0 / min_scale) * np.exp(arg.astype(np.float64)).astype(f32)
    return torch.from_numpy(table.astype(f32)).to(device)


def age_encoding(ages: torch.Tensor, d_model: int, min_scale: float = 1e-3,
                 max_scale: float = 200.0) -> torch.Tensor:
    """ages: (..., S) float years -> (..., S, d_model) fp32 sinusoidal
    features, frequencies from 1/min_scale down to 1/max_scale."""
    half = d_model // 2
    # while torch.export traces, the table is made anew (it becomes one of
    # the graph's constants): the cache would keep the tracer's fake tensor
    table = (_inv_scales.__wrapped__ if torch.compiler.is_exporting()
             else _inv_scales)
    inv_scales = table(half, min_scale, max_scale, str(ages.device))
    angles = ages.float()[..., None] * inv_scales
    enc = torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
    if enc.shape[-1] < d_model:   # odd d_model
        enc = F.pad(enc, (0, d_model - enc.shape[-1]))
    return enc


# A serving prefill (``forward``'s prefill mode and ``forward_suffix``'s
# chunks) multiplies by a layer's weights in products of exactly this many
# rows, the last one zero-padded.  cuBLAS picks a product's algorithm, and
# with it any split of the reduction over K, by the row count, so a row's
# bits would otherwise follow how many rows share its product, and a
# chunked prefill would part from the monolithic one (ROADMAP C6).  At 256
# rows a product of a large weight is near its compute bound on the card,
# and a chunk of up to 256 tokens runs one product, as one of 64 would.
PREFILL_ROWS = 256


def row_products(x: torch.Tensor, w: torch.Tensor,
                 rows: Optional[int] = None) -> torch.Tensor:
    """``x @ w`` for x (..., K) and w (K, N); with ``rows``, as products of
    exactly ``rows`` rows each (the last zero-padded), so that each row's
    bits do not depend on how many rows x holds.  A DTensor (the sharded
    step, the dry run) takes one product."""
    if rows is None or sharded.is_dtensor(x) or x.numel() == 0:
        return x @ w
    flat = x.reshape(-1, x.shape[-1]).contiguous()
    m = flat.shape[0]
    pad = -m % rows
    if pad:
        flat = F.pad(flat, (0, 0, 0, pad))
    parts = [flat[i:i + rows] @ w for i in range(0, m + pad, rows)]
    out = parts[0] if len(parts) == 1 else torch.cat(parts)
    return out[:m].view(*x.shape[:-1], w.shape[-1])


def apply_mlp(x: torch.Tensor, w_fc, b_fc, w_proj, b_proj,
              rows: Optional[int] = None) -> torch.Tensor:
    """GELU MLP (the tanh approximation, as ``jax.nn.gelu`` defaults to);
    ``rows`` as :func:`row_products`'."""
    dt = x.dtype
    h = row_products(x, w_fc.to(dt), rows) + b_fc.to(dt)
    h = F.gelu(h, approximate="tanh")
    return row_products(h, w_proj.to(dt), rows) + b_proj.to(dt)


def apply_swiglu(x: torch.Tensor, w_gate, w_up, w_down,
                 rows: Optional[int] = None) -> torch.Tensor:
    """SwiGLU MLP of the llama family: ``(silu(x @ w_gate) * (x @ w_up))
    @ w_down``, every product and the gate in x's dtype; ``rows`` as
    :func:`row_products`'."""
    dt = x.dtype
    h = (F.silu(row_products(x, w_gate.to(dt), rows))
         * row_products(x, w_up.to(dt), rows))
    return row_products(h, w_down.to(dt), rows)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """The rows of ``embed`` (V, d) at ``tokens``, in ``dtype``.  On
    DTensors each rank gathers its tokens' rows from its slice of a
    vocabulary-sharded table (zeros for the tokens outside it), and the
    rows are summed over the vocabulary axis (an all-reduce of the rows),
    as the reference's partitioner gathers a sharded table."""
    if sharded.is_dtensor(embed):
        return _sharded_embed(embed.to(dtype), tokens)
    return embed.to(dtype)[tokens.long()]


def _sharded_embed(embed, tokens):
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    dm = embed.device_mesh
    if not sharded.is_dtensor(tokens):      # plain tokens: whole on each rank
        tokens = sharded.as_batch_sharded(tokens, embed)
    rows = sharded.batch_placements(tokens.placements, dm)
    tokens = sharded.redistribute(tokens, rows)
    split = [i for i, p in enumerate(embed.placements) if p == Shard(0)
             and dm.mesh_dim_names[i] == sharded.MODEL]
    ep = [Shard(0) if i in split else Replicate() for i in range(dm.ndim)]
    # the table's gradient from each rank's rows is a partial sum over the
    # data axes
    eg = [Shard(0) if i in split else Partial() if r == Shard(0)
          else Replicate() for i, r in enumerate(rows)]
    out = [Partial() if i in split else r for i, r in enumerate(rows)]
    embed = sharded.redistribute(embed, ep)

    def local(el, tl):
        idx = tl.long()
        if not split:
            return el[idx]
        V = el.shape[0]
        idx = idx - sharded.model_rank(dm) * V
        held = (idx >= 0) & (idx < V)
        x = el[idx.clamp(0, V - 1)]
        return torch.where(held[..., None], x, torch.zeros_like(x))
    x = local_map(local, out_placements=out, in_placements=(ep, rows),
                  in_grad_placements=(eg, rows), device_mesh=dm)(embed,
                                                                  tokens)
    return sharded.reduce_rows(x)


def logits_head(embed: torch.Tensor, h: torch.Tensor,
                out_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tied head: ``h @ embed.T`` in h's dtype, then fp32 (+ fp32 bias)."""
    logits = (h @ embed.to(h.dtype).T).float()
    if out_bias is not None:
        logits = logits + out_bias.float()
    return logits


def untied_logits_head(lm_head: torch.Tensor, h: torch.Tensor,
                       out_bias: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Untied head: ``h @ lm_head`` (lm_head (d, V)) in h's dtype, then fp32
    (+ the fp32 bias of a Delphi head on an untied backbone)."""
    logits = (h @ lm_head.to(h.dtype)).float()
    if out_bias is not None:
        logits = logits + out_bias.float()
    return logits
