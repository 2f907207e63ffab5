"""Wrapper of the prefill attention kernel (``csrc/flash_attention.cu``).

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py:86``
(``flash_attention``).  The kernel reads q/k/v through their batch, head
and row strides, so the model passes transposed views of its
``(B, S, H, hd)`` projections without copies, and the output is allocated
with q's strides (``empty_like``) so the caller's transpose back is free.
With ``q_pos``/``k_pos`` the kernel masks by absolute position (the suffix
prefill of chunked admission, ``ops.suffix_prefill_attention``).
``launches`` counts the kernel's launches in this process, and
``position_launches`` those of them made with position masks.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

launches = 0
position_launches = 0
MAX_HEAD_DIM = 128


# repro-lint: disable=RL003 the CUDA launcher; its oracle is
# flash_attention_ref via ops.flash_attention (tests/test_torch_cuda.py)
def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         q_pos: Optional[torch.Tensor] = None,
                         k_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Hq, S, hd); k, v: (B, Hkv, T, hd) CUDA tensors of one dtype
    (fp32 or bf16), unit stride along hd.  Causality is by index, or, with
    ``q_pos`` (B, S) and ``k_pos`` (B, T) int positions (-1 = invalid), by
    position: key j is valid for query i iff both positions are >= 0 and,
    when causal, ``q_pos - window < k_pos <= q_pos``; a query with no valid
    key gets zeros.  Returns (B, Hq, S, hd) in q's dtype."""
    global launches, position_launches
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda takes CUDA tensors")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be (B, Hq, S, hd) and k, v (B, Hkv, T, hd)")
    B, Hq, S, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or Hq % Hkv != 0:
        raise ValueError(f"incompatible shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} > {MAX_HEAD_DIM} is not supported")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention_cuda needs unit stride along hd")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if (q_pos is None) != (k_pos is None):
        raise ValueError("pass both q_pos and k_pos, or neither")
    if q_pos is not None:
        if q_pos.shape != (B, S) or k_pos.shape != (B, T):
            raise ValueError(f"q_pos must be {(B, S)} and k_pos {(B, T)}, got "
                             f"{tuple(q_pos.shape)}, {tuple(k_pos.shape)}")
        if not (q_pos.is_cuda and k_pos.is_cuda):
            raise ValueError("flash_attention_cuda takes CUDA positions")
        q_pos = q_pos.to(torch.int32).contiguous()
        k_pos = k_pos.to(torch.int32).contiguous()
    code = build.dtype_code(q, "flash_attention")
    o = torch.empty_like(q)
    if o.stride(3) != 1:
        o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = []
    for t in (q, k, v, o):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    arr = (ctypes.c_longlong * 12)(*strides)
    rc = build.library().flash_attention_launch(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if q_pos is None else q_pos.data_ptr(),
        None if k_pos is None else k_pos.data_ptr(), arr,
        B, Hq, Hkv, S, T, hd, float(hd ** -0.5), int(causal),
        int(window or 0), build.stream_ptr(q))
    build.check(rc, "flash_attention")
    launches += 1
    if q_pos is not None:
        position_launches += 1
    return o
