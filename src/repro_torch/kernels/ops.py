"""Public kernel entry points: dispatch by the tensors' device.

A CPU tensor takes the plain PyTorch version (``kernels.ref``); a CUDA
tensor launches the hand-written kernel or the call raises.  There is no
fallback from a failed build or launch to the plain version.  Signatures
and layouts are those of the JAX package's ``kernels/ops.py``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import tte_sample as _tte

KERNEL_MODULES = {"tte_sample": _tte, "flash_attention": _flash,
                  "paged_decode_attention": _paged, "ssd_intra": _ssd}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0
    _flash.position_launches = 0


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, S, hd); k, v: (B, Hkv, T, hd) -> (B, Hq, S, hd) in q's
    dtype.  Causality is by index (query row i sees keys j <= i)."""
    if _on_cuda(q):
        return _flash.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window)
    return ref.flash_attention_ref(q, k, v, causal=causal,
                                   window=window).to(q.dtype)


def suffix_prefill_attention(q, k, v, ctx_k, ctx_v, q_pos, ctx_pos, *,
                             causal: bool = True,
                             window: Optional[int] = None,
                             q_per_kv: int = 1) -> torch.Tensor:
    """Suffix prefill (chunked admission): the chunk's queries attend over
    the cached context followed by the chunk itself, masked by absolute
    position.  q/k/v: (B, Sc, Hq|Hkv, hd) the chunk's projected heads;
    ctx_k/ctx_v: (B, C, Hkv, hd) the context gathered from the pool;
    q_pos (B, Sc) and ctx_pos (B, C) int positions, -1 = invalid (a chunk's
    padded tail, trash-block context).  Context and chunk are concatenated
    along the keys and go through the flash kernel with position masks (a
    CUDA tensor) or its plain version (a CPU tensor).  A query with no
    valid key gets zeros.  Returns (B, Sc, Hq, hd) in q's dtype."""
    if q.shape[2] != k.shape[2] * q_per_kv:
        raise ValueError(f"{q.shape[2]} query heads != {k.shape[2]} kv heads "
                         f"x q_per_kv {q_per_kv}")
    if _on_cuda(q):
        kc = torch.cat([ctx_k.to(k.dtype), k], dim=1)
        vc = torch.cat([ctx_v.to(v.dtype), v], dim=1)
        kp = torch.cat([ctx_pos.to(torch.int32), q_pos.to(torch.int32)],
                       dim=1)
        o = _flash.flash_attention_cuda(
            q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
            causal=causal, window=window, q_pos=q_pos, k_pos=kp)
        return o.transpose(1, 2)
    return ref.suffix_prefill_attention_ref(
        q, k, v, ctx_k, ctx_v, q_pos, ctx_pos, causal=causal,
        window=window).to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, table, pos, step, *,
                           window: Optional[int] = None) -> torch.Tensor:
    """One-token decode over a block pool.

    q: (B, Hq, hd) one query token per slot; k/v_pool: (NB, Hkv, bs, hd);
    table: (B, nbs) pool ids (-1 = unallocated); pos: (NB, bs) absolute
    positions (-1 = empty); step: (B,) query positions.  GQA groups the
    query heads as ``(Hkv, Hq // Hkv)``.  Returns (B, Hq, hd) in q's dtype.
    """
    B, Hq, hd = q.shape
    Hkv = k_pool.shape[1]
    q4 = q.reshape(B, Hkv, Hq // Hkv, hd)
    if _on_cuda(q):
        out = _paged.paged_decode_attention_cuda(
            q4.contiguous(), k_pool, v_pool, table.to(torch.int32),
            pos.to(torch.int32), step.to(torch.int32), window=window)
    else:
        out = ref.paged_decode_attention_ref(q4, k_pool, v_pool, table, pos,
                                             step, window=window)
    return out.reshape(B, Hq, hd).to(q.dtype)


def tte_sample(logits, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused competing-exponential sampler: (B, V) logits and uniforms ->
    (event (B,) int32, t_min (B,) fp32), ties to the lowest index."""
    logits = logits.float()
    u = u.float()
    if _on_cuda(logits):
        return _tte.tte_sample_cuda(logits.contiguous(), u.contiguous())
    return ref.tte_sample_ref(logits, u)


def ssd_intra(xdt, Bm, Cm, cum) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD in the JAX signature: xdt (BH, C, Q, P); Bm, Cm
    (BH, C, Q, N); cum (BH, C, Q).  Returns (y_diag (BH, C, Q, P),
    states (BH, C, N, P)), fp32.  The case H = 1 of :func:`ssd_intra_heads`."""
    y, st = ssd_intra_heads(xdt[:, :, :, None], Bm[:, :, :, None],
                            Cm[:, :, :, None], cum[..., None])
    return y[:, :, :, 0], st[:, :, 0]


def ssd_intra_heads(xdt, Bm, Cm, cum) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD in the model's layout: xdt (b, c, Q, H, P); Bm, Cm
    (b, c, Q, H, N), where a stride-0 head axis (``expand``) shares one
    tile among the heads; cum (b, c, Q, H).  Returns (y_diag
    (b, c, Q, H, P), states (b, c, H, N, P)), fp32."""
    if _on_cuda(xdt):
        return _ssd.ssd_intra_cuda(xdt, Bm, Cm, cum.float())
    if Bm.stride(3) == 0 and Cm.stride(3) == 0:    # broadcast, not H copies
        Bm, Cm = Bm[:, :, :, :1], Cm[:, :, :, :1]
    y, st = ref.ssd_intra_ref(xdt.transpose(2, 3), Bm.transpose(2, 3),
                              Cm.transpose(2, 3), cum.transpose(2, 3))
    return y.transpose(2, 3), st
