"""The reduction of the ``tte_sample`` CUDA kernel, emulated on the CPU.

The kernel (``src/repro_torch/kernels/csrc/tte_sample.cu``) keeps each
candidate as one 64-bit key, ``(bits(t) & 0x7fffffff) << 32 | i``, so that
one unsigned min gives the least waiting time and, among equal ones, the
lowest index.  A row is cut as the kernel cuts it: a head of 0-3 elements up
to the logits' first 16-byte boundary (taken by rank 0), a body of 16-byte
slots split into R contiguous parts (one per block of a cluster), and a tail
of 0-3 elements (taken by the last rank); each rank reduces its part to one
key, and the row's key is the min over the R partial keys.  In a warp the
kernel takes that min in two steps (min of the high words, then min of the
indices among the lanes that hold it), emulated here as well.

Here the same keys are built in plain PyTorch from the kernel's formula on
seeded numpy inputs and reduced rank by rank, and the result is held against
the JAX package's Pallas ``tte_sample`` (interpreted on the CPU through
``repro.kernels.ops``) and its oracle ``tte_sample_ref``: events exactly,
t_min within 1e-6 relative (``tests/test_kernels.py``'s tolerance; XLA's and
PyTorch's fp32 exp/log may differ by an ulp), and exactly against the port's
plain version, which computes t with the same PyTorch operations.  The cases
are the ones the sign mask and the rank split could get wrong: equal t
everywhere, runs of -0 (u = 1) from mid-row and from a rank boundary, +0
(exp(-200) = 0) beside -0, and rows of +inf.  The kernel itself is held to
the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ref

torch.set_num_threads(2)

NO_KEY = torch.iinfo(torch.int64).max      # above every real key
RANKS = (1, 3, 8)


def _t(logits, u):
    """The kernel's waiting times: -exp(-l) * ln(clip(u, 1e-12, 1 - 1e-12))."""
    return -torch.exp(-logits) * torch.log(u.clamp(1e-12, 1.0 - 1e-12))


def _keys(t, sign_mask=True):
    """(high word, index) of each element's key, as int64: the high word is
    t's fp32 bits with the sign cleared (or kept, without ``sign_mask``)."""
    hi = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if sign_mask:
        hi = hi & 0x7FFFFFFF
    return hi, torch.arange(t.shape[-1], dtype=torch.int64)


def _two_step_min(hi, lo):
    """redux.sync twice: the least high word, then the least index among
    the elements that hold it.  (NO_KEY, NO_KEY) for an empty part."""
    if hi.numel() == 0:
        return NO_KEY, NO_KEY
    mhi = hi.min()
    return int(mhi), int(lo[hi == mhi].min())


def _head(b, V):
    """Elements before row b's first 16-byte boundary, for contiguous
    (B, V) fp32 rows from a 16-byte-aligned base (as the kernel finds it)."""
    return min((-(b * V)) % 4, V)


def _parts(V, ranks, h):
    """The element ranges [a, z) each rank of the kernel reduces: the body's
    16-byte slots split into ``ranks`` contiguous parts, the head to rank 0
    and the tail to the last rank."""
    nq = (V - h) // 4
    per = -(-nq // ranks)
    parts = []
    for r in range(ranks):
        q_lo, q_hi = min(nq, r * per), min(nq, r * per + per)
        rng = [(h + 4 * q_lo, h + 4 * q_hi)]
        if r == 0:
            rng.append((0, h))
        if r == ranks - 1:
            rng.append((h + 4 * nq, V))
        parts.append(rng)
    return parts


def emulate(logits, u, ranks, sign_mask=True):
    """The kernel's result on CPU tensors: (event (B,) int32, t_min (B,)
    fp32), reduced rank by rank and then over the ranks' keys."""
    B, V = logits.shape
    t = _t(logits, u)
    evt, tmin = [], []
    for b in range(B):
        hi, lo = _keys(t[b], sign_mask)
        partial = []
        for rng in _parts(V, ranks, _head(b, V)):
            idx = torch.cat([torch.arange(a, z) for a, z in rng])
            partial.append(_two_step_min(hi[idx], lo[idx]))
        phi = torch.tensor([p[0] for p in partial])
        plo = torch.tensor([p[1] for p in partial])
        khi, klo = _two_step_min(phi, plo)
        evt.append(klo)
        tmin.append(khi)
    bits = torch.tensor(tmin, dtype=torch.int64)
    bits = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)
    return torch.tensor(evt, dtype=torch.int32), bits.view(torch.float32)


def packed_min(logits, u):
    """The same keys packed into one int64, ``(bits & 0x7fffffff) << 32 | i``,
    and reduced by one min over the row: the kernel's key order."""
    hi, lo = _keys(_t(logits, u))
    return ((hi << 32) | lo).min(dim=-1).values


_JAX = {}


def _jax(logits, u):
    """JAX's Pallas kernel (interpreted on the CPU) and its oracle."""
    key = (logits.tobytes(), u.tobytes())
    if key not in _JAX:
        e_k, t_k = jops.tte_sample(jnp.asarray(logits), jnp.asarray(u))
        e_r, t_r = jref.tte_sample_ref(jnp.asarray(logits), jnp.asarray(u))
        _JAX[key] = tuple(np.asarray(x) for x in (e_k, t_k, e_r, t_r))
    return _JAX[key]


def _check(logits, u, ranks, events=None):
    """Emulation vs the port's plain version (exact), JAX's kernel (events
    exact, t_min to 1e-6 relative where finite) and JAX's oracle (events
    exact, t_min to 1e-6 relative)."""
    lt, ut = torch.from_numpy(logits), torch.from_numpy(u)
    e, t = emulate(lt, ut, ranks)
    e_p, t_p = ref.tte_sample_ref(lt, ut)
    e_k, t_k, e_r, t_r = _jax(logits, u)
    assert e.tolist() == e_p.tolist() == e_k.tolist() == e_r.tolist()
    if events is not None:
        assert e.tolist() == events
    np.testing.assert_array_equal(t.numpy(), t_p.numpy())
    np.testing.assert_allclose(t.numpy(), t_r, rtol=1e-6)
    fin = np.isfinite(t.numpy())
    np.testing.assert_allclose(t.numpy()[fin], t_k[fin], rtol=1e-6)
    key = packed_min(lt, ut)
    assert (key & 0xFFFFFFFF).tolist() == e.tolist()
    return e, t


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("V", [5, 1289, 50304])
def test_emulation_vs_jax(V, ranks):
    rng = np.random.default_rng(V)
    logits = (rng.standard_normal((4, V)) * 3).astype(np.float32)
    u = rng.random((4, V), dtype=np.float32)
    _check(logits, u, ranks)


@pytest.mark.parametrize("ranks", RANKS)
def test_all_t_equal_goes_to_index_0(ranks):
    logits = np.zeros((4, 1289), np.float32)
    u = np.full((4, 1289), 0.3, np.float32)
    _check(logits, u, ranks, events=[0, 0, 0, 0])


@pytest.mark.parametrize("ranks", RANKS)
def test_neg_zero_run_from_mid_row(ranks):
    """u = 1 clips to 1.0f: t = -0 from index 700 (and 1000) on."""
    logits = np.zeros((2, 1289), np.float32)
    u = np.full((2, 1289), 0.3, np.float32)
    u[0, 700:] = 1.0
    u[1, 1000:] = 1.0
    _, t = _check(logits, u, ranks, events=[700, 1000])
    assert t.tolist() == [0.0, 0.0]


@pytest.mark.parametrize("ranks", RANKS)
def test_neg_zero_run_from_a_rank_boundary(ranks):
    """The run starts at the first element of a rank's part (for one rank:
    the first after the head), so the winner is found by that rank and
    every rank before it holds only larger keys."""
    V = 1289
    logits = np.zeros((4, V), np.float32)
    u = np.full((4, V), 0.3, np.float32)
    starts = []
    for b in range(4):
        rng = _parts(V, ranks, _head(b, V))[ranks // 2]
        starts.append(rng[0][0])
        u[b, starts[-1]:] = 1.0
    _check(logits, u, ranks, events=starts)


@pytest.mark.parametrize("ranks", RANKS)
def test_pos_and_neg_zero_tie_to_the_lower_index(ranks):
    """+0 (l = 200: exp(-200) = 0) and -0 (u = 1) are equal waiting times:
    the lower index wins whichever of the two it holds."""
    V = 1289
    logits = np.zeros((2, V), np.float32)
    u = np.full((2, V), 0.3, np.float32)
    u[0, 333] = 1.0           # -0 below
    logits[0, 1111] = 200.0   # +0 above
    logits[1, 333] = 200.0    # +0 below
    u[1, 1111] = 1.0          # -0 above
    _check(logits, u, ranks, events=[333, 333])


@pytest.mark.parametrize("ranks", RANKS)
def test_inf_rows(ranks):
    """l = -100: exp(100) overflows, t = +inf everywhere; event 0, t_min
    inf (JAX's Pallas kernel returns its BIG sentinel for t_min there, so
    only its event is compared)."""
    rng = np.random.default_rng(7)
    logits = np.full((3, 1289), -100.0, np.float32)
    u = rng.random((3, 1289), dtype=np.float32).clip(1e-3, 0.999)
    e, t = _check(logits, u, ranks, events=[0, 0, 0])
    assert np.isinf(t.numpy()).all()


def test_sign_mask_is_what_ties_neg_zero_to_pos_zero():
    """Without clearing the sign, -0's key (0x80000000 << 32 | i) ranks
    above every finite t, so the +0 at the higher index would win: the
    emulation without the mask disagrees with JAX's argmin."""
    V = 1289
    logits = np.zeros((1, V), np.float32)
    u = np.full((1, V), 0.3, np.float32)
    u[0, 333] = 1.0
    logits[0, 1111] = 200.0
    lt, ut = torch.from_numpy(logits), torch.from_numpy(u)
    e_r = np.asarray(jref.tte_sample_ref(jnp.asarray(logits),
                                         jnp.asarray(u))[0])
    assert emulate(lt, ut, 8)[0].tolist() == e_r.tolist() == [333]
    assert emulate(lt, ut, 8, sign_mask=False)[0].tolist() == [1111]


def test_two_step_min_is_the_packed_min():
    """The warp's two redux.sync steps give the same key as one 64-bit min,
    on keys whose high words repeat (many equal t)."""
    rng = np.random.default_rng(3)
    for _ in range(50):
        n = int(rng.integers(1, 64))
        hi = torch.from_numpy(rng.integers(0, 4, n)).to(torch.int64)
        lo = torch.from_numpy(rng.permutation(1000)[:n]).to(torch.int64)
        khi, klo = _two_step_min(hi, lo)
        assert (khi << 32) | klo == int(((hi << 32) | lo).min())
