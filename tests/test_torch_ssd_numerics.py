"""The precision route of the ``ssd_intra`` CUDA kernel, emulated on the CPU.

The kernel (``src/repro_torch/kernels/csrc/ssd_intra.cu``, bf16 B/C) runs
its three products on the tensor cores:

* S = C B^T in one bf16 pass: bf16 products are exact in fp32, only the
  order of the fp32 sums differs;
* y = (S o L) xdt in three TF32 passes, G_lo x_hi + G_hi x_lo + G_hi x_hi,
  where hi is a value rounded to TF32 (10 mantissa bits, round half away
  from zero as ``cvt.rna.tf32.f32``) and lo the rest, rounded again;
* state = B^T (dec o xdt) in three bf16 passes, dec o xdt split into three
  bf16 pieces (B is exact in bf16).

Here the same splits are taken in plain PyTorch (fp32 products of the
pieces) on seeded numpy inputs at the main path's one-chunk tile (48 heads,
Q 128, P 64, N 128; fp32 xdt, bf16 B/C shared by the heads) and held to the
kernel's tolerance, atol 1e-4, against the plain fp32 ``ssd_intra_ref``.
Single-pass TF32 misses it, which is why the kernel splits.  The tensor
cores may round their internal sums otherwise than this emulation; the
kernel itself is held to the same tolerance on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

torch.set_num_threads(2)

H, Q, P, N = 48, 128, 64, 128
TOL = 1e-4


def _tile(seed, step):
    """One chunk of the main path: xdt (H, Q, P) fp32, B and C (1, Q, N)
    rounded to bf16 and shared by the heads, cum (H, Q) of U(0, step)
    decrements, as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    xdt = torch.from_numpy(rng.standard_normal((H, Q, P), dtype=np.float32))
    Bm, Cm = (torch.from_numpy(rng.standard_normal((1, Q, N), dtype=np.float32)
                               ).to(torch.bfloat16).float() for _ in range(2))
    cum = -torch.from_numpy(np.cumsum(
        step * rng.random((H, Q), dtype=np.float32), axis=1, dtype=np.float32))
    return xdt, Bm, Cm, cum


def _tf32(x):
    """Round fp32 to TF32, half away from zero (cvt.rna.tf32.f32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _masked_scores(Bm, Cm, cum):
    """G = (C B^T) o L with L_ij = exp(cum_i - cum_j) for j <= i, else 0."""
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    seg = (cum[:, :, None] - cum[:, None, :]).masked_fill(~tri, 0.0)
    return (Cm @ Bm.transpose(-1, -2)) * torch.exp(seg).masked_fill(~tri, 0.0)


def _y_3xtf32(G, xdt):
    g_hi, x_hi = _tf32(G), _tf32(xdt)
    g_lo, x_lo = _tf32(G - g_hi), _tf32(xdt - x_hi)
    return g_lo @ x_hi + g_hi @ x_lo + g_hi @ x_hi


def _state_bf16x3(Bm, xdt, cum):
    d = torch.exp(cum[:, -1:] - cum)[..., None] * xdt
    p0 = _bf16(d)
    p1 = _bf16(d - p0)
    p2 = _bf16(d - p0 - p1)
    bt = Bm.transpose(-1, -2)
    return bt @ p2 + bt @ p1 + bt @ p0


@pytest.mark.parametrize("seed,step", [(0, 0.2), (1, 0.2), (2, 2.0)],
                         ids=["seed0", "seed1", "steep-decay"])
def test_split_precision_route_matches_plain_fp32(seed, step):
    xdt, Bm, Cm, cum = _tile(seed, step)
    y_ref, st_ref = ref.ssd_intra_ref(xdt, Bm, Cm, cum)
    y = _y_3xtf32(_masked_scores(Bm, Cm, cum), xdt)
    st = _state_bf16x3(Bm, xdt, cum)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    torch.testing.assert_close(y, y_ref, atol=TOL, rtol=0)
    torch.testing.assert_close(st, st_ref, atol=TOL, rtol=0)


def test_single_pass_tf32_misses_the_tolerance():
    """One TF32 pass for G xdt (10-bit mantissas) is far outside 1e-4 at
    this tile: the reason the kernel takes three."""
    xdt, Bm, Cm, cum = _tile(0, 0.2)
    y_ref, _ = ref.ssd_intra_ref(xdt, Bm, Cm, cum)
    G = _masked_scores(Bm, Cm, cum)
    err = float((_tf32(G) @ _tf32(xdt) - y_ref).abs().max())
    assert err > 100 * TOL
    assert float((_y_3xtf32(G, xdt) - y_ref).abs().max()) <= TOL


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 3.0], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                         -(1.0 + 2.0 ** -10), 3.0])
    assert torch.equal(_tf32(x), want)
