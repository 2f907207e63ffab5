"""The attention kernels as exportable PyTorch operators.

The wrappers launch through ``ctypes`` into fresh tensors
(``flash_attention.py``, ``paged_attention.py``), which ``torch.export``
cannot trace: a fake tensor has no ``data_ptr()``.  This module registers
the two kernels of the SDK artifact's graphs as operators of the
``repro_torch`` namespace, each with a fake implementation that gives the
output's shape, dtype and strides, so that an exported graph holds the
operator as one node:

* ``repro_torch::flash_attention`` (the ``full`` and ``prefill`` graphs)
* ``repro_torch::paged_decode_attention`` (the ``decode`` graph)

On a CUDA tensor an operator calls the kernel's wrapper (which counts its
``launches``) or raises; on a CPU tensor it runs the plain version of
``kernels.ref``.  ``kernels.ops`` calls them only while
``torch.compiler.is_exporting()``: the eager hot path calls the wrappers
directly and pays no dispatcher cost.

``tte_sample`` and ``ssd_intra`` have no operator: the artifact samples
on the host (eq. 1, or Gumbel for a generic LM), and only the dense
family is exported, which reaches no SSD kernel.

A program that loads an artifact of the port imports this module first,
so that the operators exist before ``torch.export.load`` resolves them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ref

NAMESPACE = "repro_torch"


def _flash_out(q: torch.Tensor) -> torch.Tensor:
    """The flash wrapper's output allocation: q's strides, unless hd is not
    its unit-stride axis."""
    o = torch.empty_like(q)
    if o.stride(3) != 1:
        o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return o


@torch.library.custom_op(f"{NAMESPACE}::flash_attention", mutates_args=(),
                         device_types="cpu")
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: Optional[int]) -> torch.Tensor:
    """Causal (or bidirectional) GQA attention by index: q (B, Hq, S, hd),
    k, v (B, Hkv, T, hd) -> (B, Hq, S, hd) in q's dtype, laid out as the
    kernel lays it out."""
    out = _flash_out(q)
    out.copy_(ref.flash_attention_ref(q, k, v, causal=causal, window=window))
    return out


@flash_attention.register_kernel("cuda")
def _flash_cuda(q, k, v, causal, window):
    return _flash.flash_attention_cuda(q, k, v, causal=causal, window=window)


@flash_attention.register_fake
def _flash_fake(q, k, v, causal, window):
    return _flash_out(q)


@torch.library.custom_op(f"{NAMESPACE}::paged_decode_attention",
                         mutates_args=(), device_types="cpu")
def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, table: torch.Tensor,
                           pos: torch.Tensor, step: torch.Tensor,
                           window: Optional[int]) -> torch.Tensor:
    """One-token decode over a block pool: q (B, Hkv, G, hd) contiguous,
    k/v_pool (NB, Hkv, bs, hd), int32 table (B, nbs), pos (NB, bs) and
    step (B,) -> (B, Hkv, G, hd) in q's dtype."""
    out = torch.empty_like(q)
    out.copy_(ref.paged_decode_attention_ref(q, k_pool, v_pool, table, pos,
                                             step, window=window))
    return out


@paged_decode_attention.register_kernel("cuda")
def _paged_cuda(q, k_pool, v_pool, table, pos, step, window):
    return _paged.paged_decode_attention_cuda(q, k_pool, v_pool, table, pos,
                                              step, window=window)


@paged_decode_attention.register_fake
def _paged_fake(q, k_pool, v_pool, table, pos, step, window):
    return torch.empty_like(q)
