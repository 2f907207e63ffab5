"""PyTorch/CUDA port of the serving path: Delphi-2M and Mamba2-780M.

The JAX package ``repro`` is the reference this package is held against; the
two share no code.  Plain tensor code is PyTorch; the four kernels of the
JAX package (eq.-1 sampling, prefill attention, ring/paged decode attention,
the Mamba2 SSD intra-chunk term) are CUDA C++ written for Hopper
(``repro_torch.kernels``), each beside a plain PyTorch version that CPU
tensors take.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU present the default raises rather than carrying on on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  Raises when CUDA is asked for
    (explicitly or by default) and no GPU is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path")
    return dev
