"""The kernels of the SDK artifact's graphs as exportable PyTorch operators.

The wrappers launch through ``ctypes`` into fresh tensors
(``flash_attention.py``, ``paged_attention.py``, ``ssd_scan.py``), which
``torch.export`` cannot trace: a fake tensor has no ``data_ptr()``.  This
module registers the three kernels of the graphs as operators of the
``repro_torch`` namespace, each with a fake implementation that gives the
outputs' shapes, dtypes and strides, so that an exported graph holds the
operator as one node:

* ``repro_torch::flash_attention`` (the ``full`` and ``prefill`` graphs of
  the attention stacks and of the hybrid's shared block)
* ``repro_torch::paged_decode_attention`` (their ``decode`` graphs)
* ``repro_torch::ssd_intra`` (the ``full`` and ``prefill`` graphs of
  Mamba2 and of the hybrid's Mamba2 layers; B and C reach it as the
  model's stride-0 ``expand`` over the heads, read once per batch row)

On a CUDA tensor an operator calls the kernel's wrapper (which counts its
``launches``) or raises; on a CPU tensor it runs the plain version of
``kernels.ref``.  ``kernels.ops`` calls them only while
``torch.compiler.is_exporting()``: the eager hot path calls the wrappers
directly and pays no dispatcher cost.

``tte_sample`` has no operator: the artifact samples on the host (eq. 1,
or Gumbel for a generic LM).

A program that loads an artifact of the port imports this module first,
so that the operators exist before ``torch.export.load`` resolves them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd

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


def _ssd_out(xdt: torch.Tensor, Bm: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``ssd_intra`` wrapper's output allocation: fp32, contiguous."""
    b, c, Q, H, P = xdt.shape
    N = Bm.shape[-1]
    return (torch.empty((b, c, Q, H, P), dtype=torch.float32,
                        device=xdt.device),
            torch.empty((b, c, H, N, P), dtype=torch.float32,
                        device=xdt.device))


@torch.library.custom_op(f"{NAMESPACE}::ssd_intra", mutates_args=(),
                         device_types="cpu")
def ssd_intra(xdt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
              cum: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD in the model's layout: xdt (b, c, Q, H, P); Bm, Cm
    (b, c, Q, H, N), a stride-0 head axis shared by the heads; fp32 cum
    (b, c, Q, H) -> (y_diag (b, c, Q, H, P), states (b, c, H, N, P)),
    fp32, laid out as the kernel lays them out."""
    y, st = _ssd_out(xdt, Bm)
    y_ref, st_ref = ref.ssd_intra_heads_ref(xdt, Bm, Cm, cum)
    y.copy_(y_ref)
    st.copy_(st_ref)
    return y, st


@ssd_intra.register_kernel("cuda")
def _ssd_cuda(xdt, Bm, Cm, cum):
    return _ssd.ssd_intra_cuda(xdt, Bm, Cm, cum)


@ssd_intra.register_fake
def _ssd_fake(xdt, Bm, Cm, cum):
    return _ssd_out(xdt, Bm)
