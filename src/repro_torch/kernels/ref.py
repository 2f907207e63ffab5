"""Plain PyTorch versions of the kernels (the CPU path and the oracles).

Deliberately naive, as the JAX package's ``kernels/ref.py`` they mirror:
quadratic attention, dense gathers, full materialisation of the sampled
waiting times and of the SSD decay matrix.  ``kernels.ops`` sends CPU tensors here; ``chip_smoke.py``
holds each CUDA kernel against these functions on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_pos=None,
                        k_pos=None) -> torch.Tensor:
    """q: (B, Hq, S, hd); k, v: (B, Hkv, T, hd).  GQA by head repetition;
    causality by index (query i sees keys j <= i, and j > i - window), or,
    with ``q_pos`` (B, S) and ``k_pos`` (B, T) (-1 = invalid), by position
    as the kernel's position masks: key j is valid for query i iff both
    positions are >= 0 and, when causal, ``q_pos - window < k_pos <=
    q_pos``; a query with no valid key returns zeros.
    Returns (B, Hq, S, hd) in v's dtype."""
    B, Hq, S, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = Hq // Hkv
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * hd ** -0.5
    if q_pos is not None:
        qp = q_pos.long()[:, None, :, None]
        kp = k_pos.long()[:, None, None, :]
        valid = (kp >= 0) & (qp >= 0)
        if causal:
            valid &= kp <= qp
            if window is not None:
                valid &= qp - kp < window
        s = s.masked_fill(~valid, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
        return out * valid.any(dim=-1, keepdim=True)
    if causal:
        rel = (torch.arange(S, device=q.device)[:, None]
               - torch.arange(T, device=q.device)[None, :])
        valid = rel >= 0
        if window is not None:
            valid &= rel < window
        s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def suffix_prefill_attention_ref(q, k, v, ctx_k, ctx_v, q_pos, ctx_pos, *,
                                 causal: bool = True,
                                 window: Optional[int] = None
                                 ) -> torch.Tensor:
    """Suffix prefill in the JAX layout: a chunk's queries q (B, Sc, Hq, hd)
    over the context ctx_k/ctx_v (B, C, Hkv, hd) followed by the chunk's
    own k/v (B, Sc, Hkv, hd), masked by absolute position (q_pos (B, Sc),
    ctx_pos (B, C), -1 = invalid): a dense masked softmax, as the JAX
    package's ``chunked_attention`` takes small problems, except that a
    query with no valid key (a chunk's padded tail) returns zeros.
    Returns (B, Sc, Hq, hd) in v's dtype."""
    kc = torch.cat([ctx_k.to(k.dtype), k], dim=1)
    vc = torch.cat([ctx_v.to(v.dtype), v], dim=1)
    kp = torch.cat([ctx_pos.to(q_pos.dtype), q_pos], dim=1)
    o = flash_attention_ref(q.transpose(1, 2), kc.transpose(1, 2),
                            vc.transpose(1, 2), causal=causal, window=window,
                            q_pos=q_pos, k_pos=kp)
    return o.transpose(1, 2)


def paged_decode_attention_ref(q, k_pool, v_pool, table, pos, step,
                               window: Optional[int] = None) -> torch.Tensor:
    """Paged single-token decode: dense gather + masked softmax.

    q: (B, Hkv, G, hd); k/v_pool: (NB, Hkv, bs, hd); table: (B, nbs) int32
    pool ids (-1 = unallocated); pos: (NB, bs) int32 absolute positions
    (-1 = empty); step: (B,) query positions.  Slot b attends positions in
    ``(step - W, step]`` with ``W = nbs * bs`` (and ``(step - window, ..]``).
    A slot with no valid position returns zeros, as the kernel does.
    Returns (B, Hkv, G, hd) fp32.
    """
    B, Hkv, G, hd = q.shape
    bs = k_pool.shape[2]
    nbs = table.shape[1]
    W = nbs * bs
    j = torch.arange(W, device=q.device)
    blk = table[:, j // bs].long()                     # (B, W)
    off = (j % bs).expand(B, W)
    safe = blk.clamp(min=0)
    k = k_pool[safe, :, off, :].float()                # (B, W, Hkv, hd)
    v = v_pool[safe, :, off, :].float()
    p = torch.where(blk >= 0, pos[safe, off].long(), -1)
    s = torch.einsum("bhgd,bwhd->bhgw", q.float(), k) * hd ** -0.5
    stp = step.long().reshape(B, 1, 1, 1)
    pv = p[:, None, None, :]
    valid = (pv >= 0) & (pv <= stp) & (pv > stp - W)
    if window is not None:
        valid &= pv > stp - window
    s = s.masked_fill(~valid, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgw,bwhd->bhgd", w, v)
    return out * valid.any(dim=-1, keepdim=True)


def tte_sample_ref(logits, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """Competing-exponential sampler: t_i = -exp(-logit_i) * ln(u_i).

    logits, u: (B, V).  Returns (event (B,) int32, t_min (B,) fp32); ties
    go to the lowest index."""
    u = u.float().clamp(1e-12, 1.0 - 1e-12)
    t = -torch.exp(-logits.float()) * torch.log(u)
    idx = torch.argmin(t, dim=-1)
    tmin = t.gather(-1, idx[..., None])[..., 0]
    return idx.to(torch.int32), tmin


def ssd_intra_ref(xdt, Bm, Cm, cum) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD of a batch of (head, chunk) tiles, in fp32.

    xdt: (..., Q, P) dt-scaled inputs; Bm, Cm: (..., Q, N); cum: (..., Q)
    cumulative dt*A (leading axes broadcast, so one B/C tile can serve many
    heads).  Returns (y_diag (..., Q, P), state (..., N, P)):

        y_diag = (C B^T o L) xdt,   L_ij = exp(cum_i - cum_j) for i >= j
        state  = B^T (exp(cum_last - cum) o xdt)

    ``exp`` is taken only where i >= j: above the diagonal the exponent is
    positive and could overflow (inf * 0 is NaN)."""
    xdt, Bm, Cm, cum = (t.float() for t in (xdt, Bm, Cm, cum))
    Q = xdt.shape[-2]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xdt.device).tril()
    seg = cum[..., :, None] - cum[..., None, :]
    L = torch.exp(seg.masked_fill(~tri, 0.0)).masked_fill(~tri, 0.0)
    scores = Cm @ Bm.transpose(-1, -2)                     # (..., Q, Q)
    y = (scores * L) @ xdt                                 # (..., Q, P)
    decay = torch.exp(cum[..., -1:] - cum)                 # (..., Q)
    state = Bm.transpose(-1, -2) @ (decay[..., None] * xdt)   # (..., N, P)
    return y, state


def ssd_intra_heads_ref(xdt, Bm, Cm, cum) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssd_intra_ref` in the model's layout: xdt (b, c, Q, H, P);
    Bm, Cm (b, c, Q, H, N), where a stride-0 head axis (``expand``) is
    computed once and broadcast, not as H copies; cum (b, c, Q, H).
    Returns (y_diag (b, c, Q, H, P), states (b, c, H, N, P)), fp32."""
    if Bm.stride(3) == 0 and Cm.stride(3) == 0:    # broadcast, not H copies
        Bm, Cm = Bm[:, :, :, :1], Cm[:, :, :, :1]
    y, st = ssd_intra_ref(xdt.transpose(2, 3), Bm.transpose(2, 3),
                          Cm.transpose(2, 3), cum.transpose(2, 3))
    return y.transpose(2, 3), st
