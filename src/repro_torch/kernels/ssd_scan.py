"""Wrapper of the Mamba2 SSD intra-chunk kernel (``csrc/ssd_intra.cu``).

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py:50``
(``ssd_intra``).  The kernel takes batch, chunk and head as separate axes,
each with its own stride, so the model passes ``xdt`` in its own
``(b, c, Q, H, P)`` layout and ``B``/``C`` once per batch row, broadcast
over the heads by a stride-0 head axis (``expand``), with no copies.
``launches`` counts the kernel's launches in this process.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

launches = 0
Q_TILES = (16, 32, 64, 128)
MAX_P = 64
MAX_N = 128


def ssd_intra_cuda(xdt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                   cum: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """xdt (b, c, Q, H, P) fp32 or bf16; Bm, Cm (b, c, Q, H, N) of one dtype
    (fp32 or bf16; a head stride of 0 shares one tile among the heads);
    cum (b, c, Q, H) fp32; CUDA tensors with unit stride along P and N.
    Returns (y (b, c, Q, H, P), states (b, c, H, N, P)), fp32, contiguous."""
    global launches
    if not (xdt.is_cuda and Bm.is_cuda and Cm.is_cuda and cum.is_cuda):
        raise ValueError("ssd_intra_cuda takes CUDA tensors")
    if xdt.dim() != 5:
        raise ValueError(f"xdt must be (b, c, Q, H, P), got {tuple(xdt.shape)}")
    b, c, Q, H, P = xdt.shape
    N = Bm.shape[-1]
    if Bm.shape != (b, c, Q, H, N) or Cm.shape != Bm.shape:
        raise ValueError(f"Bm {tuple(Bm.shape)} and Cm {tuple(Cm.shape)} must "
                         f"be (b, c, Q, H, N) = {(b, c, Q, H, N)}")
    if cum.shape != (b, c, Q, H):
        raise ValueError(f"cum {tuple(cum.shape)} must be {(b, c, Q, H)}")
    if Q not in Q_TILES or not 1 <= P <= MAX_P or not 1 <= N <= MAX_N:
        raise ValueError(f"ssd_intra_cuda takes Q in {Q_TILES}, P <= {MAX_P}, "
                         f"N <= {MAX_N}; got Q={Q} P={P} N={N}")
    if Bm.dtype != Cm.dtype:
        raise TypeError("Bm and Cm must share one dtype")
    if cum.dtype != torch.float32:
        raise TypeError("ssd_intra_cuda takes float32 cum")
    if xdt.stride(4) != 1 or Bm.stride(4) != 1 or Cm.stride(4) != 1:
        raise ValueError("ssd_intra_cuda needs unit stride along P and N")
    code_x = build.dtype_code(xdt, "ssd_intra")
    code_bc = build.dtype_code(Bm, "ssd_intra")
    dev = xdt.device
    y = torch.empty((b, c, Q, H, P), dtype=torch.float32, device=dev)
    st = torch.empty((b, c, H, N, P), dtype=torch.float32, device=dev)
    strides = []
    for t in (xdt, Bm, Cm, cum, y):          # (b, c, h, row = Q)
        strides += [t.stride(0), t.stride(1), t.stride(3), t.stride(2)]
    strides += [st.stride(0), st.stride(1), st.stride(2), st.stride(3)]
    arr = (ctypes.c_longlong * 24)(*strides)
    rc = build.library().ssd_intra_launch(
        code_x, code_bc, xdt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        cum.data_ptr(), y.data_ptr(), st.data_ptr(), arr, b, H, c, Q, P, N,
        build.stream_ptr(xdt))
    build.check(rc, "ssd_intra")
    launches += 1
    return y, st
