"""Shared layers: norms, continuous age encoding, GELU MLP, embedding and
the tied and untied logits heads.

Compute runs in the activation dtype ``cfg.dtype``; parameters stay fp32
and are cast at use (``.to`` is a no-op for weights already cast by
``models.model.cast_params``).  Numerics follow the JAX package's
``models/layers.py``: norms in fp32 with population variance, the tanh
GELU, and heads whose product runs in the activation dtype before the
logits go to fp32 (and the fp32 ``out_bias`` is added).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

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
    inv_scales = _inv_scales(half, min_scale, max_scale, str(ages.device))
    angles = ages.float()[..., None] * inv_scales
    enc = torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
    if enc.shape[-1] < d_model:   # odd d_model
        enc = F.pad(enc, (0, d_model - enc.shape[-1]))
    return enc


def apply_mlp(x: torch.Tensor, w_fc, b_fc, w_proj, b_proj) -> torch.Tensor:
    """GELU MLP (the tanh approximation, as ``jax.nn.gelu`` defaults to)."""
    dt = x.dtype
    h = x @ w_fc.to(dt) + b_fc.to(dt)
    h = F.gelu(h, approximate="tanh")
    return h @ w_proj.to(dt) + b_proj.to(dt)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    return embed.to(dtype)[tokens.long()]


def logits_head(embed: torch.Tensor, h: torch.Tensor,
                out_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tied head: ``h @ embed.T`` in h's dtype, then fp32 (+ fp32 bias)."""
    logits = (h @ embed.to(h.dtype).T).float()
    if out_bias is not None:
        logits = logits + out_bias.float()
    return logits


def untied_logits_head(lm_head: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Untied head: ``h @ lm_head`` (lm_head (d, V)) in h's dtype, then fp32."""
    return (h @ lm_head.to(h.dtype)).float()
