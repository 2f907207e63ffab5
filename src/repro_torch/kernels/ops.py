"""Public kernel entry points: dispatch by the tensors' device.

A CPU tensor takes the plain PyTorch version (``kernels.ref``); a CUDA
tensor launches the hand-written kernel or the call raises.  There is no
fallback from a failed build or launch to the plain version.  Signatures
and layouts are those of the JAX package's ``kernels/ops.py``.

No kernel has a backward (nor has any Pallas kernel of the JAX package):
a kernel writes into a fresh tensor through ``ctypes``, so its output has
no autograd history.  Every entry point therefore refuses, on both
devices, a call made with gradients enabled on an input that requires
them; otherwise a loss reaching a kernel would train correctly on the CPU
(whose plain version is differentiable) and lose the gradient silently on
the card.  Training takes the plain differentiable route instead
(``models.attention.chunked_attention``).

While ``torch.export`` traces (the SDK artifact's graphs), the two
attention entry points and ``ssd_intra_heads`` go through the operators of
``kernels.library`` instead, so that the exported graph calls the kernel
(or, on the CPU, the plain version) as one node.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import library
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


def _refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd would need a backward through kernel ``name``."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: an input requires grad with gradients "
            f"enabled.  Run inference under torch.no_grad() or "
            f"torch.inference_mode() on parameters that do not require "
            f"grad; train through the differentiable plain route "
            f"(forward(..., differentiable=True)).")


def _on_cuda(t: torch.Tensor) -> bool:
    """True on the card (the kernel); False on the CPU and on the meta
    device (the plain version: the dry run's shape and FLOP accounting
    runs no kernel, and counts the same work whatever implements it)."""
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"no kernel for device {t.device}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, S, hd); k, v: (B, Hkv, T, hd) -> (B, Hq, S, hd) in q's
    dtype.  Causality is by index (query row i sees keys j <= i)."""
    _refuse_grad("flash_attention", q, k, v)
    if torch.compiler.is_exporting():
        return library.flash_attention(q, k, v, causal, window)
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
    _refuse_grad("suffix_prefill_attention", q, k, v, ctx_k, ctx_v)
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
    _refuse_grad("paged_decode_attention", q, k_pool, v_pool)
    B, Hq, hd = q.shape
    Hkv = k_pool.shape[1]
    q4 = q.reshape(B, Hkv, Hq // Hkv, hd)
    if torch.compiler.is_exporting():
        out = library.paged_decode_attention(
            q4.contiguous(), k_pool, v_pool, table.to(torch.int32),
            pos.to(torch.int32), step.to(torch.int32), window)
    elif _on_cuda(q):
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
    _refuse_grad("tte_sample", logits, u)
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
    _refuse_grad("ssd_intra", xdt, Bm, Cm, cum)
    if torch.compiler.is_exporting():
        return library.ssd_intra(xdt, Bm, Cm, cum.float())
    if _on_cuda(xdt):
        return _ssd.ssd_intra_cuda(xdt, Bm, Cm, cum.float())
    return ref.ssd_intra_heads_ref(xdt, Bm, Cm, cum)
