"""Wrapper of the fused eq.-1 sampler kernel (``csrc/tte_sample.cu``).

Replaces the TPU kernel ``src/repro/kernels/tte_sample.py:64``
(``tte_sample``).  ``launches`` counts the kernel's launches in this
process; nothing else changes it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

launches = 0


def tte_sample_cuda(logits: torch.Tensor, u: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits, u: (B, V) fp32 CUDA tensors with unit stride along V ->
    (event (B,) int32, t_min (B,) fp32)."""
    global launches
    if not (logits.is_cuda and u.is_cuda):
        raise ValueError("tte_sample_cuda takes CUDA tensors")
    if logits.dim() != 2 or logits.shape != u.shape:
        raise ValueError(f"logits {tuple(logits.shape)} and u "
                         f"{tuple(u.shape)} must be the same (B, V)")
    if logits.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError("tte_sample_cuda takes float32 logits and uniforms")
    if logits.stride(1) != 1 or u.stride(1) != 1:
        raise ValueError("tte_sample_cuda needs unit stride along V")
    B, V = logits.shape
    if V == 0:
        raise ValueError("tte_sample_cuda needs a non-empty vocabulary")
    evt = torch.empty((B,), dtype=torch.int32, device=logits.device)
    tmin = torch.empty((B,), dtype=torch.float32, device=logits.device)
    rc = build.library().tte_sample_launch(
        logits.data_ptr(), u.data_ptr(), logits.stride(0), u.stride(0), B, V,
        evt.data_ptr(), tmin.data_ptr(), build.stream_ptr(logits))
    build.check(rc, "tte_sample")
    launches += 1
    return evt, tmin
