"""Wrapper of the fused eq.-1 sampler kernel (``csrc/tte_sample.cu``).

Replaces the TPU kernel ``src/repro/kernels/tte_sample.py:64``
(``tte_sample``).  ``launches`` counts the kernel's launches in this
process; nothing else changes it.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

launches = 0


def tte_sample_cuda(logits: torch.Tensor, u: torch.Tensor, *,
                    cluster: int = 0, per_thread: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits, u: (B, V) fp32 CUDA tensors with unit stride along V ->
    (event (B,) int32, t_min (B,) fp32).

    ``cluster`` (blocks per row, 1-8) and ``per_thread`` (elements a
    thread takes per round, 4 or 8) force the kernel's plan, for
    measurement; 0 lets the kernel pick by B and V (:func:`plan`)."""
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
    # event and t_min in one allocation: row 1 holds t_min's fp32 bits
    buf = torch.empty((2, B), dtype=torch.int32, device=logits.device)
    evt, tmin = buf[0], buf[1].view(torch.float32)
    rc = build.library().tte_sample_launch(
        logits.data_ptr(), u.data_ptr(), logits.stride(0), u.stride(0), B, V,
        evt.data_ptr(), tmin.data_ptr(), cluster, per_thread,
        build.stream_ptr(logits))
    build.check(rc, "tte_sample")
    launches += 1
    return evt, tmin


def plan(B: int, V: int, *, cluster: int = 0, per_thread: int = 0
         ) -> Dict[str, int]:
    """The kernel's plan for (B, V) rows (logits and uniforms aligned
    alike) under the given overrides: blocks per row, elements a thread
    takes per round, threads a block, and how many such clusters the card
    holds at once (``cudaOccupancyMaxActiveClusters``).  Needs the card."""
    out = (ctypes.c_int * 4)()
    rc = build.library().tte_sample_plan(B, V, cluster, per_thread, out)
    build.check(rc, "tte_sample plan")
    return {"cluster": out[0], "per_thread": out[1], "threads": out[2],
            "resident_clusters": out[3]}
