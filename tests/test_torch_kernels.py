"""The port's plain kernel versions against the JAX package's kernels.

The same numpy-seeded inputs go through ``repro_torch.kernels`` (CPU
tensors take the plain PyTorch versions) and through the JAX package's
Pallas kernels in interpret mode (``repro.kernels.ops``) or its oracles
(``repro.kernels.ref``), as ``tests/test_kernels.py`` runs them.
Tolerances are those of ``tests/test_kernels.py``: fp32 atol 2e-5, bf16
atol 2e-2 (bf16 inputs, fp32 reference on the rounded values), and exact
events for the sampler with t_min within 1e-6 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn

torch.set_num_threads(2)


def _tol(dtype):
    return 2e-5 if dtype == torch.float32 else 2e-2


# ---------------------------------------------------------------------------
# tte_sample
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,V", [(1, 64), (3, 1289), (2, 2048), (1, 50304),
                                 (2, 100)])
def test_tte_sample_vs_jax_kernel(B, V):
    rng = np.random.default_rng(V)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    u = rng.random((B, V), dtype=np.float32)
    e_t, t_t = ops.tte_sample(torch.from_numpy(logits), torch.from_numpy(u))
    e_j, t_j = jops.tte_sample(jnp.asarray(logits), jnp.asarray(u))
    assert e_t.dtype == torch.int32 and t_t.dtype == torch.float32
    assert e_t.tolist() == np.asarray(e_j).tolist()
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=1e-6)
    e_r, t_r = jref.tte_sample_ref(jnp.asarray(logits), jnp.asarray(u))
    assert e_t.tolist() == np.asarray(e_r).tolist()


def test_tte_sample_ties_and_clip():
    """Equal waiting times go to the lowest index (jnp.argmin's rule), and
    u = 1 clips to 1 - 1e-12, which is 1.0 in fp32: t = -0 wins."""
    logits = np.zeros((3, 50), np.float32)
    u = np.full((3, 50), 0.3, np.float32)
    u[1, 9:] = 1.0
    u[2, 4] = 0.0                     # clipped to 1e-12: a huge waiting time
    e_t, t_t = ops.tte_sample(torch.from_numpy(logits), torch.from_numpy(u))
    e_j, t_j = jref.tte_sample_ref(jnp.asarray(logits), jnp.asarray(u))
    assert e_t.tolist() == np.asarray(e_j).tolist() == [0, 9, 0]
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------
FLASH_CASES = [
    # (B, Hq, Hkv, S, hd, window, dtype): tests/test_kernels.py FLASH_CASES
    # plus Delphi-2M's head width
    (1, 1, 1, 128, 64, None, torch.float32),
    (2, 4, 2, 256, 64, None, torch.float32),
    (2, 4, 1, 256, 32, None, torch.float32),
    (1, 2, 2, 384, 128, 100, torch.float32),
    (1, 2, 2, 200, 64, None, torch.float32),
    (2, 2, 2, 256, 64, None, torch.bfloat16),
    (1, 8, 2, 128, 16, 40, torch.float32),
    (4, 12, 12, 32, 10, None, torch.bfloat16),
]


def _rand(rng, shape, dtype):
    """A numpy-seeded tensor in ``dtype`` and its values as fp32 numpy."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    t = t.to(dtype)
    return t, t.float().numpy()


@pytest.mark.parametrize("B,Hq,Hkv,S,hd,window,dtype", FLASH_CASES)
def test_flash_attention_vs_jax_ref(B, Hq, Hkv, S, hd, window, dtype):
    rng = np.random.default_rng(S * hd)
    (q, qn), (k, kn), (v, vn) = (_rand(rng, (B, h, S, hd), dtype)
                                 for h in (Hq, Hkv, Hkv))
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    want = jref.flash_attention_ref(jnp.asarray(qn), jnp.asarray(kn),
                                    jnp.asarray(vn), causal=True,
                                    window=window)
    assert out.dtype == dtype and out.shape == (B, Hq, S, hd)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want),
                               atol=_tol(dtype))


def test_flash_attention_bidirectional_vs_jax_kernel():
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((1, 2, 128, 64)).astype(np.float32)
               for _ in range(3))
    out = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=False)
    want = jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5)


def test_prefill_attention_vs_jax_chunked_attention():
    """The model's prefill path (transposed (B, S, H, hd) views into the
    flash entry point) equals the JAX model's ``chunked_attention`` with
    positions 0..S-1, for a right-padded batch."""
    rng = np.random.default_rng(11)
    B, S, H, hd = 3, 24, 12, 10
    q, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    out = tattn.prefill_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    pos = jnp.arange(S, dtype=jnp.int32)
    want = jattn.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   pos, pos, causal=True, window=None)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5)


# ---------------------------------------------------------------------------
# paged_decode_attention
# ---------------------------------------------------------------------------
PAGED_CASES = [
    # (B, Hkv, G, hd, bs, nbs, window, dtype): tests/test_kernels.py
    (1, 1, 1, 32, 4, 2, None, torch.float32),
    (2, 2, 2, 16, 4, 4, None, torch.float32),
    (3, 1, 4, 64, 8, 2, None, torch.float32),
    (2, 2, 1, 16, 4, 4, 6, torch.float32),
    (2, 2, 2, 32, 8, 4, None, torch.bfloat16),
]


def _paged_inputs(seed, B, Hkv, G, hd, bs, nbs, dtype, *, wrap=False):
    """The construction of tests/test_kernels.py (slot b holds n_tok
    sequential tokens blockwise) with the blocks scattered over the pool:
    numpy arrays, the pool and q rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    NB = 1 + B * nbs
    W = nbs * bs
    perm = rng.permutation(np.arange(1, NB))
    k_pool = _rand(rng, (NB, Hkv, bs, hd), dtype)[1]
    v_pool = _rand(rng, (NB, Hkv, bs, hd), dtype)[1]
    q = _rand(rng, (B, Hkv * G, hd), dtype)[1]
    table = np.full((B, nbs), -1, np.int32)
    pos = np.full((NB, bs), -1, np.int32)
    step = np.zeros((B,), np.int32)
    nxt = 0
    for b in range(B):
        n_tok = int(rng.integers(1, W))
        step[b] = n_tok + (W if wrap else 0)
        for jb in range(-(-n_tok // bs)):
            blk = int(perm[nxt])
            nxt += 1
            table[b, jb] = blk
            for o in range(bs):
                p = jb * bs + o
                if p < n_tok:
                    pos[blk, o] = p + (W if wrap else 0)
    return q, k_pool, v_pool, table, pos, step


def _port_paged(q, k, v, table, pos, step, dtype, window=None):
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out = ops.paged_decode_attention(
        *(x.to(dtype) for x in t), torch.from_numpy(table),
        torch.from_numpy(pos), torch.from_numpy(step), window=window)
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("B,Hkv,G,hd,bs,nbs,window,dtype", PAGED_CASES)
def test_paged_decode_vs_jax(B, Hkv, G, hd, bs, nbs, window, dtype):
    q, k, v, table, pos, step = _paged_inputs(B * 100 + bs, B, Hkv, G, hd,
                                              bs, nbs, dtype)
    out = _port_paged(q, k, v, table, pos, step, dtype, window)
    want = jref.paged_decode_attention_ref(
        jnp.asarray(q).reshape(B, Hkv, G, hd), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(table), jnp.asarray(pos),
        jnp.asarray(step), window=window)
    np.testing.assert_allclose(out, np.asarray(want).reshape(B, Hkv * G, hd),
                               atol=_tol(dtype))
    if (B, G) == (2, 2) and dtype == torch.float32:
        # and the Pallas kernel itself, interpreted (seconds per call)
        kern = jops.paged_decode_attention(
            *(jnp.asarray(a) for a in (q, k, v, table, pos, step)),
            window=window)
        np.testing.assert_allclose(out, np.asarray(kern), atol=2e-5)


def test_paged_decode_wrapped_ring_eviction():
    """step >= W with stale entries one ring width back: the mask
    ``p > step - W`` drops them exactly as the JAX kernel does, and pushing
    them further back changes nothing."""
    B, Hkv, G, hd, bs, nbs = 2, 2, 2, 16, 4, 4
    W = nbs * bs
    q, k, v, table, pos, step = _paged_inputs(6, B, Hkv, G, hd, bs, nbs,
                                              torch.float32, wrap=True)
    stale = (pos >= 0) & (np.arange(bs)[None, :] % 2 == 0)
    pos = np.where(stale, pos - W, pos).astype(np.int32)
    # every slot keeps a valid position (the JAX kernel's contract)
    assert all((pos[table[b][table[b] >= 0]] > step[b] - W).any()
               for b in range(B))
    out = _port_paged(q, k, v, table, pos, step, torch.float32)
    kern = jops.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, k, v, table, pos, step)))
    np.testing.assert_allclose(out, np.asarray(kern), atol=2e-5)
    pos2 = np.where(stale, pos - 5 * W, pos).astype(np.int32)
    out2 = _port_paged(q, k, v, table, pos2, step, torch.float32)
    np.testing.assert_array_equal(out, out2)


def test_paged_decode_skips_unallocated_and_empty_slots():
    """Table entries of -1 are never read (a poisoned trash block changes
    nothing) and a slot with no valid position gives zeros, as the JAX
    kernel's clamp of l at 1e-30 does."""
    B, Hkv, G, hd, bs, nbs = 2, 1, 2, 16, 4, 4
    q, k, v, table, pos, step = _paged_inputs(9, B, Hkv, G, hd, bs, nbs,
                                              torch.float32)
    out = _port_paged(q, k, v, table, pos, step, torch.float32)
    k2, v2 = k.copy(), v.copy()
    k2[0], v2[0] = 1e9, 1e9
    np.testing.assert_array_equal(
        out, _port_paged(q, k2, v2, table, pos, step, torch.float32))
    table[1] = -1
    out = _port_paged(q, k, v, table, pos, step, torch.float32)
    kern = jops.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, k, v, table, pos, step)))
    np.testing.assert_array_equal(out[1], 0.0)
    np.testing.assert_allclose(out, np.asarray(kern), atol=2e-5)


@pytest.mark.parametrize("step_of", [lambda W: [5, W - 1, 0],
                                     lambda W: [W, 2 * W + 3, 3 * W - 1]],
                         ids=["filling", "wrapped"])
def test_ring_as_pool_vs_jax_decode_attention(step_of):
    """One layer's ring decode in the port (write the new token into ring
    slot step % W in place, then the paged kernel with the ring viewed as a
    pool of one block per slot) against the JAX model's
    ``decode_attention`` with the deferred-write merge of k_new/v_new."""
    rng = np.random.default_rng(21)
    B, H, hd, W = 3, 4, 10, 16
    steps = np.asarray(step_of(W), np.int32)
    k = rng.standard_normal((B, H, W, hd)).astype(np.float32)
    v = rng.standard_normal((B, H, W, hd)).astype(np.float32)
    pos = np.full((B, W), -1, np.int32)
    for b, s in enumerate(steps):      # positions s - W + 1 .. s - 1 held
        for p in range(max(0, s - W), s):
            pos[b, p % W] = p
    pos[0, 1] = -1                     # a masked padding position
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k_new = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    v_new = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    want = jattn.decode_attention(
        jnp.asarray(q), jattn.LayerCache(jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(pos)),
        jnp.asarray(steps), window=None, k_new=jnp.asarray(k_new),
        v_new=jnp.asarray(v_new))
    cache = tattn.LayerCache(k=torch.from_numpy(k)[None].clone(),
                             v=torch.from_numpy(v)[None].clone(),
                             pos=torch.from_numpy(pos)[None].clone())
    step_t = torch.from_numpy(steps)
    slot = tattn.write_ring_positions(cache, step_t)
    table = torch.arange(B, dtype=torch.int32)[:, None]
    out = tattn.ring_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new),
        cache, 0, slot, step_t, table)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5)
    # the new token now sits at ring slot step % W of the cache
    rows = np.arange(B)
    np.testing.assert_array_equal(cache.pos[0, rows, steps % W].numpy(), steps)
    np.testing.assert_array_equal(cache.k[0, rows, :, steps % W].numpy(),
                                  k_new[:, 0])


def test_cache_from_prefill_vs_jax():
    rng = np.random.default_rng(4)
    for S, W in ((5, 8), (8, 8), (13, 8)):
        k = rng.standard_normal((2, S, 3, 4)).astype(np.float32)
        v = rng.standard_normal((2, S, 3, 4)).astype(np.float32)
        positions = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
        want = jattn.cache_from_prefill(jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(positions), W)
        got = tattn.cache_from_prefill(torch.from_numpy(k),
                                       torch.from_numpy(v),
                                       torch.from_numpy(positions.copy()), W)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
