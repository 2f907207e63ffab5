"""Mamba2 (SSD, state-space duality) block: chunked scan and decode step
(the JAX package's ``models/ssm.py``).

The SSD formulation of arXiv:2405.21060 with n_groups = 1:

    h_t = exp(dt_t * A_h) h_{t-1} + dt_t * B_t (x) x_t        (per head h)
    y_t = C_t . h_t + D_h x_t

Prefill runs the chunked algorithm: the intra-chunk quadratic term and the
chunk states go through the ``ssd_intra`` kernel (``kernels.ops``); the
inter-chunk recurrence over chunk states and the off-diagonal term stay
plain PyTorch (a Python loop over chunks, O(S / Q)).  Training takes the
differentiable route of the same algorithm (``differentiable=True``): the
intra-chunk term and the chunk states in plain fp32 ops, as the JAX
package's ``ssd_chunked`` computes them, since the kernel has no backward.
Decode is the O(1) recurrent step against a constant-size state.

Numerics follow the JAX code, including where it rounds: the depthwise
conv is four unrolled adds in the activation dtype, ``ssd_chunked``
computes in fp32 and returns ``y`` in x's dtype (the ``D`` skip is then
added in that dtype in prefill, but in fp32 in decode), the gated norm runs
in fp32 over the whole d_inner, and the prefill's conv tail is recomputed
by a second product ``x_tail @ in_proj[:, xBC]``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops


class SSMCache(NamedTuple):
    """Decode state, stacked over layers by the model."""
    h: torch.Tensor       # (L, B, H, N, P) fp32 SSD state
    conv: torch.Tensor    # (L, B, conv, d_inner + 2N) raw conv inputs, activation dtype


def conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


def _causal_depthwise_conv(x, w, b):
    """x: (B, S, C); w: (W, C) depthwise kernel; causal (left) zero padding.
    Four unrolled adds in x's dtype, each rounding, as the JAX code."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for k in range(W):
        out = out + xp[:, k:k + x.shape[1], :] * w[k]
    return out + b


def _intra_plain(xdt, Bm, Cm, cum):
    """The intra-chunk term and the chunk states in plain, differentiable
    fp32 ops (the JAX package's ``ssd_chunked`` body).  xdt (b, c, Q, H,
    P) fp32; Bm, Cm (b, c, Q, N); cum (b, c, Q, H).  Returns (y_diag
    (b, c, Q, H, P), states (b, c, H, N, P)).

    ``exp`` is taken only where i >= j: above the diagonal the exponent is
    positive, and an overflow there would turn the masked product's
    gradient into NaN (JAX's ``where(tri, exp(seg), 0)`` gives the same
    values but not that guarantee)."""
    Q = xdt.shape[2]
    Bc, Cc = Bm.float(), Cm.float()
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xdt.device).tril()
    tri = tri[None, None, :, :, None]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]           # (b,c,i,j,H)
    zero = torch.zeros((), dtype=seg.dtype, device=seg.device)
    L = torch.where(tri, torch.exp(torch.where(tri, seg, zero)), zero)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * L, xdt)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)              # (b,c,Q,H)
    states = torch.einsum("bcjn,bcjhp->bchnp", Bc,
                          decay_to_end[..., None] * xdt)
    return y_diag, states


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None,
                differentiable: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: (B, S, H, P); dt: (B, S, H) (post-softplus); A: (H,) negative;
    Bm, Cm: (B, S, N).  Returns (y (B, S, H, P) in x's dtype, h_last
    (B, H, N, P) fp32).  S must be a multiple of ``chunk`` (callers pad).
    The intra-chunk term runs the ``ssd_intra`` kernel, or with
    ``differentiable=True`` plain fp32 ops (the training route)."""
    b, s, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    c = s // Q
    f32 = torch.float32

    xdt = (x.float() * dt.float()[..., None]).reshape(b, c, Q, H, P)
    dtA = (dt.float() * A.float()).reshape(b, c, Q, H)            # negative
    cum = torch.cumsum(dtA, dim=2)                                 # (b,c,Q,H)

    if differentiable:
        y_diag, states = _intra_plain(xdt, Bm.reshape(b, c, Q, N),
                                      Cm.reshape(b, c, Q, N), cum)
    else:
        # the kernel, with B and C read once per batch row (a stride-0
        # head axis), in their own dtype
        Bc = Bm.reshape(b, c, Q, 1, N).expand(b, c, Q, H, N)
        Cc = Cm.reshape(b, c, Q, 1, N).expand(b, c, Q, H, N)
        y_diag, states = ops.ssd_intra_heads(xdt, Bc, Cc, cum)
    chunk_decay = torch.exp(cum[:, :, -1, :])                      # (b,c,H)

    # inter-chunk recurrence: the state entering each chunk
    h = (torch.zeros((b, H, N, P), dtype=f32, device=x.device)
         if h0 is None else h0.float())
    h_prev = []
    for k in range(c):
        h_prev.append(h)
        h = chunk_decay[:, k, :, None, None] * h + states[:, k]
    h_prev = torch.stack(h_prev, dim=1)                            # (b,c,H,N,P)

    y_off = torch.einsum("bcin,bchnp,bcih->bcihp", Cm.float().reshape(b, c, Q, N),
                         h_prev, torch.exp(cum))
    y = (y_diag + y_off).reshape(b, s, H, P)
    return y.to(x.dtype), h


def _split_proj(zxbcdt, cfg: ModelConfig):
    di, N = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * N]
    dt_raw = zxbcdt[..., di + di + 2 * N:]
    return z, xBC, dt_raw


def _gated_norm(y, z, scale, eps: float = 1e-5):
    """RMSNorm of ``y * silu(z)`` over the whole d_inner, in fp32."""
    g = y.float() * F.silu(z.float())
    ms = g.square().mean(dim=-1, keepdim=True)
    return (g * torch.rsqrt(ms + eps) * scale.float()).to(y.dtype)


def _dt_and_A(dt_raw, p):
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    return dt, A


def ssm_forward(p, x, cfg: ModelConfig, h0=None, return_state: bool = False,
                differentiable: bool = False):
    """Full-sequence Mamba2 block.  ``p``: one layer's ``layers/ssm/*``
    tensors keyed by their last name; x: (B, S, d_model).  With
    ``return_state`` also returns this layer's (h (B, H, N, P) fp32,
    conv (B, conv, ch)) decode state.  ``differentiable=True`` takes the
    plain SSD route (:func:`ssd_chunked`), which autograd can go through."""
    dt_act = x.dtype
    B_, S, _ = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads, cfg.ssm_head_dim

    zxbcdt = x @ p["in_proj"].to(dt_act)
    z, xBC, dt_raw = _split_proj(zxbcdt, cfg)
    xBC = F.silu(_causal_depthwise_conv(xBC, p["conv_w"].to(dt_act),
                                        p["conv_b"].to(dt_act)))
    x_ssm, Bm, Cm = xBC[..., :di], xBC[..., di:di + N], xBC[..., di + N:]
    dt, A = _dt_and_A(dt_raw, p)                                   # (B,S,H)

    xh = x_ssm.reshape(B_, S, H, P)
    Q = cfg.ssm_chunk
    pad = (-S) % Q
    if pad:            # dt = 0 on the padding: identity steps
        xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt_p = F.pad(dt, (0, 0, 0, pad))
        Bm_p = F.pad(Bm, (0, 0, 0, pad))
        Cm_p = F.pad(Cm, (0, 0, 0, pad))
    else:
        xh_p, dt_p, Bm_p, Cm_p = xh, dt, Bm, Cm

    y, h_last = ssd_chunked(xh_p, dt_p, A, Bm_p, Cm_p, Q, h0=h0,
                            differentiable=differentiable)
    y = y[:, :S]
    y = y + p["D"].to(y.dtype)[:, None] * xh
    y = y.reshape(B_, S, di)
    y = _gated_norm(y, z, p["norm_scale"])
    out = y @ p["out_proj"].to(dt_act)
    if not return_state:
        return out
    W = cfg.ssm_conv
    # the last W raw (pre-conv) xBC inputs, zero-padded on the left
    x_tail = x[:, max(S - W, 0):, :]
    tail = x_tail @ p["in_proj"][:, di:di + di + 2 * N].to(dt_act)
    if S < W:
        tail = F.pad(tail, (0, 0, W - S, 0))
    return out, (h_last, tail)


def ssm_decode_step(p, x, h, conv, cfg: ModelConfig):
    """One-token recurrent step.  x: (B, 1, d_model); h (B, H, N, P) fp32
    and conv (B, W, ch) this layer's state.  Returns (out (B, 1, d_model),
    new h, new conv)."""
    dt_act = x.dtype
    B_ = x.shape[0]
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads, cfg.ssm_head_dim

    zxbcdt = x[:, 0] @ p["in_proj"].to(dt_act)                     # (B, ...)
    z, xBC_new, dt_raw = _split_proj(zxbcdt, cfg)
    conv = torch.cat([conv[:, 1:], xBC_new[:, None, :].to(conv.dtype)], dim=1)
    # einsum("bwc,wc->bc") in the activation dtype: products exact in fp32,
    # summed in fp32, rounded once
    xBC = (conv.float() * p["conv_w"].to(dt_act).float()).sum(dim=1).to(dt_act)
    xBC = F.silu(xBC + p["conv_b"].to(dt_act))
    x_ssm, Bm, Cm = xBC[..., :di], xBC[..., di:di + N], xBC[..., di + N:]
    dt, A = _dt_and_A(dt_raw, p)                                   # (B,H)
    a = torch.exp(dt * A)

    xh = x_ssm.reshape(B_, H, P).float()
    upd = torch.einsum("bn,bhp->bhnp", Bm.float(), dt[..., None] * xh)
    h = a[:, :, None, None] * h + upd
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), h)
    y = y + p["D"].float()[None, :, None] * xh
    y = y.reshape(B_, di).to(dt_act)
    y = _gated_norm(y, z, p["norm_scale"])
    out = (y @ p["out_proj"].to(dt_act))[:, None, :]
    return out, h, conv


def empty_ssm_cache(cfg: ModelConfig, n_layers: int, batch: int,
                    dtype: torch.dtype, device) -> SSMCache:
    return SSMCache(
        h=torch.zeros((n_layers, batch, cfg.ssm_n_heads, cfg.ssm_state,
                       cfg.ssm_head_dim), dtype=torch.float32, device=device),
        conv=torch.zeros((n_layers, batch, cfg.ssm_conv, conv_channels(cfg)),
                         dtype=dtype, device=device))


def layer_params(params, l: int) -> dict:
    """Layer ``l``'s ``layers/ssm/*`` tensors keyed by their last name."""
    pre = "layers/ssm/"
    return {k[len(pre):]: v[l] for k, v in params.items() if k.startswith(pre)}
