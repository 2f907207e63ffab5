"""Wrapper of the paged decode attention kernel (``csrc/paged_attention.cu``).

Replaces the TPU kernel ``src/repro/kernels/paged_attention.py:82``
(``paged_decode_attention``).  The serving engine's ring cache calls it as
a pool of one block per slot (``NB = B``, ``bs = W``, table
``arange(B)[:, None]``); the paged cache of a later slice calls it
unchanged.  Any G is taken: the kernel splits a kv head's query heads
into blocks of at most 8, and its shared memory is static (16.6 KB at most,
checked when it is compiled), so there is nothing to ask the library per
call.  ``launches`` counts the kernel's launches in this process.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

launches = 0
MAX_HEAD_DIM = 128


# repro-lint: disable=RL003 the CUDA launcher; its oracle is
# paged_decode_attention_ref via ops.paged_decode_attention
# (tests/test_torch_cuda.py)
def paged_decode_attention_cuda(q, k_pool, v_pool, table, pos, step, *,
                                window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hkv, G, hd); k/v_pool: (NB, Hkv, bs, hd), one dtype (fp32 or
    bf16); table: (B, nbs), pos: (NB, bs), step: (B,) int32; all contiguous
    CUDA tensors.  Returns (B, Hkv, G, hd) in q's dtype."""
    global launches
    tensors = (q, k_pool, v_pool, table, pos, step)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("paged_decode_attention_cuda takes CUDA tensors")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention_cuda takes contiguous tensors")
    B, Hkv, G, hd = q.shape
    NB, _, bs, _ = k_pool.shape
    nbs = table.shape[1]
    if (k_pool.shape != v_pool.shape or k_pool.shape[1] != Hkv
            or k_pool.shape[3] != hd or table.shape[0] != B
            or pos.shape != (NB, bs) or step.shape != (B,)):
        raise ValueError(
            f"incompatible shapes q {tuple(q.shape)}, pool "
            f"{tuple(k_pool.shape)}, table {tuple(table.shape)}, pos "
            f"{tuple(pos.shape)}, step {tuple(step.shape)}")
    if not (q.dtype == k_pool.dtype == v_pool.dtype):
        raise TypeError("q and the pools must share one dtype")
    if not (table.dtype == pos.dtype == step.dtype == torch.int32):
        raise TypeError("table, pos and step must be int32")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} > {MAX_HEAD_DIM} is not supported")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    code = build.dtype_code(q, "paged_decode_attention")
    out = torch.empty_like(q)
    rc = build.library().paged_decode_launch(
        code, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        table.data_ptr(), pos.data_ptr(), step.data_ptr(), out.data_ptr(),
        B, Hkv, G, hd, bs, nbs, int(window or 0), float(hd ** -0.5),
        build.stream_ptr(q))
    build.check(rc, "paged_decode_attention")
    launches += 1
    return out
