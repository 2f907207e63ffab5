"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and ``nvcc`` (the kernels are built at first
use); without a card each one skips.  They import neither JAX nor the JAX
package, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances are those of ``tests/test_kernels.py``, fp32 atol 2e-5 and bf16
atol 2e-2, against the plain version in fp32 on the same rounded inputs;
in bf16 no more than 3e-2 of the reference's largest value (``_tol``),
which over 4,096 keys also fails a kernel that drops its last key tile;
the sampler's events are equal except at near-ties (waiting times within
1e-6 relative) and t_min agrees to 1e-6 relative; the SSD kernel's fp32
sums agree with the plain version's to atol 1e-4 (``test_kernels.py``'s
SSD tolerance) on the same (rounded) inputs.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pk
from repro_torch.kernels import ssd_scan as sk
from repro_torch.kernels import tte_sample as tk
from repro_torch.models.layers import PREFILL_ROWS, row_products

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    """A seeded generator on the card; skips the test where there is none
    (decided here, at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _tol(dtype, want):
    """fp32 atol 2e-5; bf16 atol 3e-2 of the reference's largest value, at
    most 2e-2: outputs over 4,096 keys have a std of ~0.026, and a fixed
    2e-2 would pass a kernel that skipped a whole key tile."""
    if dtype == torch.float32:
        return 2e-5
    return min(2e-2, 3e-2 * float(want.abs().max()))


def _misses(bad, want, tol):
    """True where ``bad`` (a kernel's output had it dropped its last key
    tile, in the kernel's dtype) differs from ``want`` by more than tol."""
    return float((bad.float() - want).abs().max()) > tol


TTE_VS = (1, 31, 32, 33, 1023, 1024, 1025, 1289, 8191, 8192, 8193, 50280,
          256206)
TTE_SHAPES = sorted({(B, V) for V in TTE_VS for B in (1, 16)}
                    | {(64, 1289), (3, 256206), (2, 100), (1, 5)})


def _tte_vs_plain(logits, u, **plan):
    """Launch the kernel once on (logits, u) and hold it against the plain
    version: events equal except at near-ties (t within 1e-6 relative),
    t_min within 1e-6 relative.  Returns the events."""
    B = logits.shape[0]
    n0 = tk.launches
    e1, t1 = tk.tte_sample_cuda(logits, u, **plan)
    e2, t2 = ref.tte_sample_ref(logits, u)
    assert tk.launches == n0 + 1
    t_all = -torch.exp(-logits) * torch.log(u.clamp(1e-12, 1.0 - 1e-12))
    rows = torch.arange(B, device="cuda")
    gap = (t_all[rows, e1.long()] - t_all[rows, e2.long()]).abs()
    assert bool(((e1 == e2) | (gap <= 1e-6 * t2.abs())).all())
    torch.testing.assert_close(t1, t2, rtol=1e-6, atol=0)
    return e1


@pytest.mark.parametrize("B,V", TTE_SHAPES)
def test_tte_sample_kernel_vs_plain(gen, B, V):
    logits = torch.randn((B, V), generator=gen, device="cuda") * 3 - 4
    u = torch.rand((B, V), generator=gen, device="cuda")
    n0 = tk.launches
    e1, t1 = ops.tte_sample(logits, u)
    e2, t2 = ref.tte_sample_ref(logits, u)
    assert tk.launches == n0 + 1
    t_all = -torch.exp(-logits) * torch.log(u.clamp(1e-12, 1.0 - 1e-12))
    rows = torch.arange(B, device="cuda")
    gap = (t_all[rows, e1.long()] - t_all[rows, e2.long()]).abs()
    assert bool(((e1 == e2) | (gap <= 1e-6 * t2.abs())).all())
    torch.testing.assert_close(t1, t2, rtol=1e-6, atol=0)


@pytest.mark.parametrize("V", [1289, 50280, 256206])
@pytest.mark.parametrize("cluster,per_thread", [
    (1, 4), (1, 8), (2, 8), (3, 8), (4, 4), (4, 8), (5, 4), (6, 8), (7, 8),
    (8, 4), (8, 8)])
def test_tte_sample_kernel_every_plan(gen, V, cluster, per_thread):
    """Each cluster size and elements-per-thread instance the measurements
    try agrees with the plain version, rows misaligned (odd V) included."""
    logits = torch.randn((5, V), generator=gen, device="cuda") * 3 - 4
    u = torch.rand((5, V), generator=gen, device="cuda")
    _tte_vs_plain(logits, u, cluster=cluster, per_thread=per_thread)


@pytest.mark.parametrize("plan", [{"cluster": 9}, {"cluster": -1},
                                  {"per_thread": 16}, {"per_thread": 6}])
def test_tte_sample_kernel_refuses_a_bad_plan(gen, plan):
    logits = torch.randn((2, 8192), generator=gen, device="cuda")
    n0 = tk.launches
    with pytest.raises(RuntimeError, match="tte_sample"):
        tk.tte_sample_cuda(logits, torch.rand_like(logits), **plan)
    assert tk.launches == n0


def test_tte_sample_kernel_ties(gen):
    logits = torch.zeros((3, 300), device="cuda")
    u = torch.full((3, 300), 0.3, device="cuda")
    u[1, 37:] = 1.0
    evt, _ = tk.tte_sample_cuda(logits, u)
    assert evt.tolist() == [0, 37, 0]


@pytest.mark.parametrize("cluster", [0, 4, 8])
def test_tte_sample_kernel_ties_across_cluster_ranks(cluster):
    """Equal t everywhere goes to index 0.  -0 (u = 1) and +0 (l = 200)
    are equal: a run of -0 from an index j inside the third of eight ranks
    goes to j, with +0 after it in later ranks; +0 at j loses to -0 at an
    index in the first rank.  A +inf row (l = -100) gives event 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    V = 256206
    j = int(V * 2.5 / 8)
    logits = torch.zeros((5, V), device="cuda")
    u = torch.full((5, V), 0.3, device="cuda")
    u[1, j:] = 1.0
    u[2, j:j + 5000] = 1.0
    logits[2, j + 5000:] = 200.0
    logits[3] = -100.0
    logits[4, j] = 200.0
    u[4, j + 9] = 1.0
    u[4, j - 70000] = 1.0
    n0 = tk.launches
    evt, tmin = tk.tte_sample_cuda(logits, u, cluster=cluster)
    assert tk.launches == n0 + 1
    assert evt.tolist() == [0, j, j, 0, j - 70000]
    assert tmin[1:3].tolist() == [0.0, 0.0] and tmin[4].item() == 0.0
    assert tmin[3].item() == float("inf")
    torch.testing.assert_close(tmin, ref.tte_sample_ref(logits, u)[1],
                               rtol=0, atol=0)


@pytest.mark.parametrize("V", [5, 1289, 256206])
def test_tte_sample_kernel_inf_row(V):
    """l = -100 gives t = +inf everywhere: event 0, t_min inf."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    logits = torch.full((2, V), -100.0, device="cuda")
    u = torch.rand((2, V), device="cuda").clamp(1e-3, 0.999)
    n0 = tk.launches
    evt, tmin = tk.tte_sample_cuda(logits, u)
    assert tk.launches == n0 + 1
    assert evt.tolist() == [0, 0]
    assert tmin.tolist() == [float("inf")] * 2


@pytest.mark.parametrize("V", [1289, 50280, 256206])
def test_tte_sample_kernel_strided_and_misaligned_rows(gen, V):
    """Row-strided views (``big[:, :V]`` of a (B, V + 37) buffer), and
    logits and uniforms aligned differently (read by 4-byte words)."""
    big_l = torch.randn((6, V + 37), generator=gen, device="cuda") * 3 - 4
    big_u = torch.rand((6, V + 37), generator=gen, device="cuda")
    _tte_vs_plain(big_l[:, :V], big_u[:, :V])
    _tte_vs_plain(big_l[:, 1:V + 1], big_u[:, :V])
    _tte_vs_plain(big_l[:, 3:V + 3], big_u[:, 2:V + 2])


@pytest.mark.parametrize("B,Hq,Hkv,S,hd,window,causal,dtype", [
    (16, 12, 12, 32, 10, None, True, torch.bfloat16),
    (4, 12, 12, 256, 10, None, True, torch.bfloat16),
    (2, 12, 12, 200, 10, 100, True, torch.float32),
    (2, 4, 2, 256, 64, None, True, torch.float32),
    (2, 8, 2, 77, 64, 16, True, torch.bfloat16),
    (1, 2, 2, 130, 128, None, True, torch.float32),
    (1, 2, 2, 128, 64, None, False, torch.float32),
    # the tensor-core route (bf16) at every head-width class and mask
    (16, 12, 12, 8, 10, None, True, torch.bfloat16),
    (16, 12, 12, 16, 10, None, True, torch.bfloat16),
    (2, 12, 12, 200, 10, 100, True, torch.bfloat16),
    (2, 12, 12, 40, 10, None, False, torch.bfloat16),
    (2, 4, 4, 96, 32, None, True, torch.bfloat16),
    (2, 4, 2, 70, 40, None, True, torch.bfloat16),    # padded 40 -> 64
    (2, 4, 2, 50, 12, None, True, torch.bfloat16),    # 8-byte staging
    (2, 4, 2, 50, 9, None, True, torch.bfloat16),     # odd hd: by element
    (2, 4, 2, 256, 64, None, True, torch.bfloat16),
    (1, 2, 2, 130, 128, None, True, torch.bfloat16),
    (1, 2, 2, 128, 64, None, False, torch.bfloat16),
    # the dense LMs' prefill: TinyLlama (GQA 32/4, hd 64) and H2O-Danube
    # (32/8, hd 80 padded to 128, a window of 4096 that a 4608-token row
    # passes)
    (1, 32, 4, 4608, 64, None, True, torch.bfloat16),
    (1, 32, 8, 4608, 80, 4096, True, torch.bfloat16),
    (1, 32, 8, 4608, 80, 4096, True, torch.float32),
    # Zamba2's shared block: MHA 32/32 at hd 64 (its window of 4096 does
    # not bite at 1024 tokens)
    (1, 32, 32, 1024, 64, 4096, True, torch.bfloat16),
    # the MoE LMs' prefill (OLMoE, Qwen2-MoE): MHA 16/16 at hd 128, the
    # kernels' largest head
    (2, 16, 16, 1024, 128, None, True, torch.bfloat16),
    # InternVL2's prefill (GQA 48/8 at hd 128) and SeamlessM4T's encoder
    # (bidirectional MHA 16/16 at hd 64, S = T = 4096)
    (8, 48, 8, 1024, 128, None, True, torch.bfloat16),
    (8, 48, 8, 1024, 128, None, True, torch.float32),
    (8, 16, 16, 4096, 64, None, False, torch.bfloat16),
    (8, 16, 16, 4096, 64, None, False, torch.float32),
    # Qwen2.5-32B's prefill: GQA 40/8 at hd 128 (G 5), at its bucket of 8
    # x 1,024 and at 4,096 tokens; DeepSeek-7B's: MHA 32/32 at hd 128
    (8, 40, 8, 1024, 128, None, True, torch.bfloat16),
    (8, 40, 8, 1024, 128, None, True, torch.float32),
    (1, 40, 8, 4096, 128, None, True, torch.bfloat16),
    (8, 32, 32, 1024, 128, None, True, torch.bfloat16),
])
def test_flash_attention_kernel_vs_plain(gen, B, Hq, Hkv, S, hd, window,
                                         causal, dtype):
    def rnd(h):          # transposed views of (B, S, H, hd), as the model
        return torch.randn((B, S, h, hd), generator=gen, device="cuda"
                           ).to(dtype).transpose(1, 2)
    q, k, v = rnd(Hq), rnd(Hkv), rnd(Hkv)
    n0 = fk.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert fk.launches == n0 + 1 and out.dtype == dtype
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
    tol = _tol(dtype, want)
    torch.testing.assert_close(out.float(), want, atol=tol, rtol=0)
    if S >= 4096 and window is None:
        if causal:        # the last 128 keys masked for every query
            pos = torch.arange(S, dtype=torch.int32, device="cuda").expand(
                B, S)
            kpos = pos.clone()
            kpos[:, -128:] = -1
            bad = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                          q_pos=pos, k_pos=kpos)
        else:
            bad = ref.flash_attention_ref(q.float(), k[:, :, :-128].float(),
                                          v[:, :, :-128].float(),
                                          causal=False)
        assert _misses(bad.to(dtype), want, tol)


@pytest.mark.parametrize("B,Hq,Hkv,S,T,hd", [
    (2, 4, 2, 37, 300, 64),
    (1, 2, 2, 130, 17, 128),
    # SeamlessM4T's cross-attention prefill: 64 decoder queries over the
    # 4096 memory keys
    (8, 16, 16, 64, 4096, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_non_causal_t_ne_s(gen, B, Hq, Hkv, S, T, hd,
                                                  dtype):
    """Non-causal with T keys for S queries (cross-attention's prefill):
    every key visible to every query, the ragged T edge masked."""
    def rnd(n, h):
        return torch.randn((B, n, h, hd), generator=gen, device="cuda"
                           ).to(dtype).transpose(1, 2)
    q, k, v = rnd(S, Hq), rnd(T, Hkv), rnd(T, Hkv)
    n0 = fk.launches
    out = ops.flash_attention(q, k, v, causal=False)
    assert fk.launches == n0 + 1 and out.shape == q.shape
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=False)
    tol = _tol(dtype, want)
    torch.testing.assert_close(out.float(), want, atol=tol, rtol=0)
    if T >= 4096:
        bad = ref.flash_attention_ref(q.float(), k[:, :, :-128].float(),
                                      v[:, :, :-128].float(), causal=False)
        assert _misses(bad.to(dtype), want, tol)


SUFFIX_SHAPES = [
    # (B, Sc, C, Hkv, G, hd, window): tests/test_kernels.py's SUFFIX_CASES,
    # then Delphi-2M's chunk (64 tokens over 128 context keys)
    (1, 16, 0, 1, 1, 32, None),
    (2, 16, 32, 2, 2, 32, None),
    (1, 8, 24, 1, 4, 64, None),
    (2, 16, 16, 2, 1, 16, 12),
    (1, 16, 32, 2, 2, 32, None),
    (1, 64, 128, 12, 1, 10, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sc,C,Hkv,G,hd,window", SUFFIX_SHAPES)
def test_flash_position_masks_vs_plain(gen, B, Sc, C, Hkv, G, hd, window,
                                       dtype):
    """The position-masked routes through ``ops.suffix_prefill_attention``
    against ``suffix_prefill_attention_ref`` in fp32 on the same rounded
    inputs: context padded with trash positions (-1), the chunk's tail
    padded (-1); the padded rows come out as exact zeros."""
    Hq = Hkv * G

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q, k, v = rnd(B, Sc, Hq, hd), rnd(B, Sc, Hkv, hd), rnd(B, Sc, Hkv, hd)
    ck, cv = rnd(B, C, Hkv, hd), rnd(B, C, Hkv, hd)
    n_ctx, n_q = max(C - 3, 0), Sc - 2
    cpos = torch.full((B, C), -1, dtype=torch.int32, device="cuda")
    cpos[:, :n_ctx] = torch.arange(n_ctx, dtype=torch.int32, device="cuda")
    qpos = torch.full((B, Sc), -1, dtype=torch.int32, device="cuda")
    qpos[:, :n_q] = n_ctx + torch.arange(n_q, dtype=torch.int32,
                                         device="cuda")
    n0, p0 = fk.launches, fk.position_launches
    out = ops.suffix_prefill_attention(q, k, v, ck, cv, qpos, cpos,
                                       window=window, q_per_kv=G)
    assert fk.launches == n0 + 1 and fk.position_launches == p0 + 1
    want = ref.suffix_prefill_attention_ref(
        q.float(), k.float(), v.float(), ck.float(), cv.float(), qpos, cpos,
        window=window)
    torch.testing.assert_close(out[:, :n_q].float(), want[:, :n_q],
                               atol=_tol(dtype, want[:, :n_q]), rtol=0)
    assert not out[:, n_q:].any(), "padded rows must be exact zeros"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,n", [(8, 5), (32, 21), (64, 64), (256, 200)])
def test_head_chunk_by_position_equals_index_route(gen, S, n, dtype):
    """A chunk at the prompt head with no context, masked by position,
    gives the index-masked route's bits on its valid rows (Delphi's heads:
    12 x hd 10): what keeps an unbounded chunk budget bit-equal to the
    monolithic prefill on the card."""
    def rnd(h):
        return torch.randn((1, S, h, 10), generator=gen, device="cuda"
                           ).to(dtype)
    q, k, v = rnd(12), rnd(12), rnd(12)
    pos = torch.full((1, S), -1, dtype=torch.int32, device="cuda")
    pos[:, :n] = torch.arange(n, dtype=torch.int32, device="cuda")
    empty = q.new_zeros((1, 0, 12, 10))
    by_pos = ops.suffix_prefill_attention(
        q, k, v, empty, empty, pos, pos[:, :0])
    by_index = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2)).transpose(1, 2)
    assert torch.equal(by_pos[:, :n], by_index[:, :n])


@pytest.mark.parametrize("B,Hkv,G,hd,bs,nbs,window,dtype", [
    (16, 12, 1, 10, 256, 1, None, torch.bfloat16),   # the ring as a pool
    (3, 2, 4, 64, 4, 8, None, torch.float32),
    (4, 2, 2, 32, 16, 4, 20, torch.float32),
    (2, 2, 8, 128, 16, 4, None, torch.bfloat16),
    (3, 2, 4, 16, 16, 4, 20, torch.bfloat16),
    (16, 12, 1, 10, 256, 1, None, torch.float32),
    (2, 2, 2, 9, 16, 2, None, torch.bfloat16),       # odd hd: by element
    # the dense LMs' decode: TinyLlama's G 8 at hd 64; H2O-Danube's G 4 at
    # hd 80 with its window of 4096 inside a 5120-token ring
    (4, 4, 8, 64, 16, 64, None, torch.bfloat16),
    (2, 8, 4, 80, 16, 320, 4096, torch.bfloat16),
    (2, 8, 4, 80, 16, 320, 4096, torch.float32),
    # Zamba2's ring: 8 slots x 32 kv heads, G 1 at hd 64, W = window 4096
    (8, 32, 1, 64, 4096, 1, 4096, torch.bfloat16),
    # the MoE LMs' ring: 8 slots x 16 kv heads, G 1 at hd 128, W 1024
    (8, 16, 1, 128, 1024, 1, None, torch.bfloat16),
    # InternVL2's ring: 8 slots x 8 kv heads, G 6 at hd 128, W 1280
    (8, 8, 6, 128, 1280, 1, None, torch.bfloat16),
    (8, 8, 6, 128, 1280, 1, None, torch.float32),
    # Qwen2.5-32B's ring: G 5 at hd 128 (five query heads a KV head: one a
    # block, each K/V row read 5 times), W 1024, and the same on a pool of
    # 16-token blocks; DeepSeek-7B's: G 1 over 32 kv heads at hd 128
    (8, 8, 5, 128, 1024, 1, None, torch.bfloat16),
    (8, 8, 5, 128, 1024, 1, None, torch.float32),
    (2, 8, 5, 128, 16, 64, None, torch.bfloat16),
    (2, 8, 5, 128, 16, 64, None, torch.float32),
    (8, 32, 1, 128, 1024, 1, None, torch.bfloat16),
])
def test_paged_decode_kernel_vs_plain(gen, B, Hkv, G, hd, bs, nbs, window,
                                      dtype):
    NB = 1 + B * nbs
    W = nbs * bs
    perm = torch.randperm(NB - 1, generator=gen, device="cuda") + 1
    table = torch.full((B, nbs), -1, dtype=torch.int32, device="cuda")
    pos = torch.full((NB, bs), -1, dtype=torch.int32, device="cuda")
    steps = torch.randint(W // 2, 3 * W, (B,), generator=gen, device="cuda")
    for b in range(B):                       # positions step-W+1 .. step
        table[b] = perm[b * nbs:(b + 1) * nbs].to(torch.int32)
        for p in range(int(steps[b]) - W + 1, int(steps[b]) + 1):
            if p >= 0:
                pos[table[b, (p % W) // bs], p % bs] = p
    table[0, -1] = -1                         # an unallocated block
    q = torch.randn((B, Hkv * G, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((NB, Hkv, bs, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((NB, Hkv, bs, hd), generator=gen, device="cuda").to(dtype)
    step = steps.to(torch.int32)
    n0 = pk.launches
    out = ops.paged_decode_attention(q, k, v, table, pos, step, window=window)
    assert pk.launches == n0 + 1 and out.dtype == dtype
    want = ref.paged_decode_attention_ref(
        q.float().reshape(B, Hkv, G, hd), k.float(), v.float(), table, pos,
        step, window=window).reshape(B, Hkv * G, hd)
    torch.testing.assert_close(out.float(), want, atol=_tol(dtype, want),
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_decode_over_a_full_cross_ring(gen, dtype):
    """SeamlessM4T's cross ring (8 slots x 16 kv heads, G 1, hd 64, every
    one of 4096 memory positions valid) through
    ``models.attention.cross_decode_attention`` (step W - 1) against the
    plain version and against an unmasked softmax over every position;
    the plain version at the reference's step 2**30 masks them all (the
    trap the step avoids)."""
    from repro_torch.models import attention as attn
    B, Hkv, W, hd = 8, 16, 4096, 64
    k, v = (torch.randn((1, B, Hkv, W, hd), generator=gen, device="cuda"
                        ).to(dtype) for _ in range(2))
    pos = torch.arange(W, dtype=torch.int32, device="cuda").expand(
        1, B, W).contiguous()
    q = torch.randn((B, 1, Hkv, hd), generator=gen, device="cuda").to(dtype)
    table = torch.arange(B, dtype=torch.int32, device="cuda")[:, None]
    n0 = pk.launches
    out = attn.cross_decode_attention(q, attn.LayerCache(k, v, pos), 0,
                                      table)
    assert pk.launches == n0 + 1 and out.shape == q.shape
    step = torch.full((B,), W - 1, dtype=torch.int32, device="cuda")
    want = ref.paged_decode_attention_ref(
        q[:, 0].float().reshape(B, Hkv, 1, hd), k[0].float(), v[0].float(),
        table, pos[0], step).reshape(B, 1, Hkv, hd)
    tol = _tol(dtype, want)
    torch.testing.assert_close(out.float(), want, atol=tol, rtol=0)
    s = torch.einsum("bhd,bhwd->bhw", q[:, 0].float(), k[0].float()) \
        * hd ** -0.5
    dense = torch.einsum("bhw,bhwd->bhd", torch.softmax(s, -1), v[0].float())
    torch.testing.assert_close(out[:, 0].float(), dense, atol=tol, rtol=0)
    short = torch.where(pos[0] < W - 128, pos[0], -1)
    bad = ref.paged_decode_attention_ref(
        q[:, 0].float().reshape(B, Hkv, 1, hd), k[0].float(), v[0].float(),
        table, short, step).reshape(B, 1, Hkv, hd)
    assert _misses(bad.to(dtype), want, tol)
    trap = ref.paged_decode_attention_ref(
        q[:, 0].float().reshape(B, Hkv, 1, hd), k[0].float(), v[0].float(),
        table, pos[0], torch.full_like(step, 2 ** 30))
    assert float(trap.abs().max()) == 0.0


@pytest.mark.parametrize("first,spread", [(3, 8), (255, 37)],
                         ids=["steps-below-128", "full-ring"])
def test_paged_decode_kernel_ring_occupancy(gen, first, spread):
    """The main path's ring (16 slots, 12 kv heads, hd 10, W 256, bf16)
    with every slot's valid tokens in the ring's first half, and with
    every slot full (all 256 positions valid, wrapped)."""
    B, Hkv, hd, W = 16, 12, 10, 256
    step = (first + spread * torch.arange(B, device="cuda")).to(torch.int32)
    j = torch.arange(W, device="cuda")
    pos = (step[:, None] - torch.remainder(step[:, None] - j, W)).to(
        torch.int32)                          # position p at ring slot p % W
    pos = torch.where(pos >= 0, pos, -1)
    q = torch.randn((B, Hkv, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn((B, Hkv, W, hd), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    table = torch.arange(B, dtype=torch.int32, device="cuda")[:, None]
    out = ops.paged_decode_attention(q, k, v, table, pos, step)
    want = ref.paged_decode_attention_ref(
        q.float()[:, :, None], k.float(), v.float(), table, pos,
        step)[:, :, 0]
    torch.testing.assert_close(out.float(), want,
                               atol=_tol(torch.bfloat16, want), rtol=0)


def test_paged_decode_kernel_empty_slot_gives_zeros(gen):
    q = torch.randn((2, 2, 16), generator=gen, device="cuda")
    k = torch.randn((3, 2, 4, 16), generator=gen, device="cuda")
    table = torch.tensor([[1, 2], [-1, -1]], dtype=torch.int32, device="cuda")
    pos = torch.arange(12, dtype=torch.int32, device="cuda").reshape(3, 4)
    step = torch.tensor([7, 7], dtype=torch.int32, device="cuda")
    out = ops.paged_decode_attention(q, k, k.clone(), table, pos - 4, step)
    assert float(out[1].abs().max()) == 0.0
    assert float(out[0].abs().max()) > 0.0


def test_paged_decode_kernel_paged_pool_with_holes(gen):
    """The paged Delphi path's pool (16 slots, 12 kv heads, hd 10, bs 16,
    nbs 16, 257 blocks, bf16): unallocated (-1) table columns between
    allocated ones, and the trash block 0 written with positions that would
    be valid (as idle slots' discarded writes leave it) but that no table
    points at.  Against the plain version, and bit for bit against the
    same tokens laid out as a ring (bs 256, nbs 1): the kernel walks the
    logical positions in the same order whatever the block size."""
    B, Hkv, hd, bs, nbs = 16, 12, 10, 16, 16
    W, NB = bs * nbs, 1 + B * nbs
    dt = torch.bfloat16
    step = (40 + 29 * torch.arange(B, device="cuda")).to(torch.int32)
    perm = torch.randperm(NB - 1, generator=gen, device="cuda") + 1
    table = perm.reshape(B, nbs).to(torch.int32)
    j = torch.arange(W, device="cuda")
    ring_pos = (step[:, None] - torch.remainder(step[:, None] - j, W))
    ring_pos = torch.where(ring_pos >= 0, ring_pos, -1).to(torch.int32)
    holes = torch.rand((B, nbs), generator=gen, device="cuda") < 0.3
    holes[:, 0] = False
    table = torch.where(holes, -1, table)
    ring_pos = torch.where(holes.repeat_interleave(bs, 1), -1, ring_pos)
    ring_k, ring_v = (torch.randn((B, Hkv, W, hd), generator=gen,
                                  device="cuda").to(dt) for _ in range(2))
    k = torch.randn((NB, Hkv, bs, hd), generator=gen, device="cuda").to(dt)
    v = torch.randn((NB, Hkv, bs, hd), generator=gen, device="cuda").to(dt)
    pos = torch.full((NB, bs), -1, dtype=torch.int32, device="cuda")
    for b in range(B):
        for jb in range(nbs):
            blk = int(table[b, jb])
            if blk > 0:
                sl = slice(jb * bs, (jb + 1) * bs)
                k[blk] = ring_k[b, :, sl]
                v[blk] = ring_v[b, :, sl]
                pos[blk] = ring_pos[b, sl]
    pos[0] = step[0] - torch.arange(bs, device="cuda", dtype=torch.int32)
    q = torch.randn((B, Hkv, hd), generator=gen, device="cuda").to(dt)
    out = ops.paged_decode_attention(q, k, v, table, pos, step)
    want = ref.paged_decode_attention_ref(
        q.float()[:, :, None], k.float(), v.float(), table, pos,
        step)[:, :, 0]
    torch.testing.assert_close(out.float(), want,
                               atol=_tol(torch.bfloat16, want), rtol=0)
    ring = ops.paged_decode_attention(
        q, ring_k, ring_v, torch.arange(B, dtype=torch.int32,
                                        device="cuda")[:, None],
        ring_pos, step)
    assert torch.equal(out, ring)


def _delphi_bf16():
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("delphi-2m", reduced=True).replace(
        vocab_size=96, max_seq_len=48, max_age=1e9)
    return init_params(cfg, seed=7, device="cuda"), cfg


def test_paged_engine_bit_identical_to_ring_on_card(gen):
    """bf16 on the card, injected uniforms: the paged engine's tokens and
    fp32 ages equal the ring engine's bit for bit, an over-width prompt
    (S > W, solo admission of the wrapped ring) included."""
    import numpy as np
    from repro_torch.serve import BatchedEngine, Request
    params, cfg = _delphi_bf16()
    rng = np.random.default_rng(0)
    prompts = [(S, rng.random((8, cfg.vocab_size), dtype=np.float32))
               for S in (3, 5, 9, 17, 30, 70)]
    outs = []
    for kw in ({}, {"cache": "paged", "block_size": 16}):
        eng = BatchedEngine(params, cfg, slots=4, max_context=64,
                            device="cuda", **kw)
        reqs = [Request(tokens=(np.arange(3, 3 + S) % 90).astype(np.int32),
                        ages=np.linspace(0.0, 30.0, S).astype(np.float32),
                        max_new=8, uniforms=u) for S, u in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.done and r.error is None for r in reqs)
        outs.append([(r.out_tokens, r.out_ages) for r in reqs])
    assert outs[0] == outs[1]
    assert eng.allocator.used == 0


def test_generic_lm_engine_ring_equals_paged_on_card(gen):
    """Reduced TinyLlama (RoPE, GQA, SwiGLU, RMSNorm, untied head) in bf16
    on the card, injected uniforms: the paged engine's tokens, and the
    paged engine's with 32-token chunked prefill, equal the ring engine's
    bit for bit; 2 flash launches an admission batch, 2 paged a tick."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import BatchedEngine, Request
    cfg = get_config("tinyllama-1.1b", reduced=True)
    params = init_params(cfg, seed=3, device="cuda")
    rng = np.random.default_rng(1)
    prompts = [(rng.integers(0, cfg.vocab_size, S).astype(np.int32),
                rng.random((10, cfg.vocab_size), dtype=np.float32))
               for S in (5, 20, 33, 70, 90, 120)]
    outs = []
    for kw in ({}, {"cache": "paged"},
               {"cache": "paged", "prefill_chunk_tokens": 32}):
        eng = BatchedEngine(params, cfg, slots=3, max_context=256,
                            device="cuda", **kw)
        reqs = [Request(tokens=t, max_new=10, uniforms=u)
                for t, u in prompts]
        for r in reqs:
            eng.submit(r)
        ops.reset_launch_counts()
        eng.run()
        counts = ops.launch_counts()
        assert all(r.done and r.error is None and len(r.out_tokens) == 10
                   for r in reqs)
        assert counts["paged_decode_attention"] == 2 * eng.ticks
        assert counts["tte_sample"] == 0
        if "prefill_chunk_tokens" not in kw:
            assert counts["flash_attention"] == 2 * eng.admit_batches
        outs.append([r.out_tokens for r in reqs])
    assert outs[0] == outs[1] == outs[2]


@pytest.mark.parametrize("arch,change", [
    ("qwen2-moe-a2.7b", {}),
    ("qwen2-moe-a2.7b", dict(n_experts=16, top_k=4))], ids=["reduced", "wide"])
def test_apply_moe_on_card_equals_cpu(gen, arch, change):
    """``models.moe.apply_moe`` in fp32 (TF32 off) on the card against the
    CPU on the same weights and inputs: the same experts, y within 1e-5
    (the CPU tests' allowance against JAX), the aux within 1e-6."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models import moe
    from repro_torch.models.model import Block
    cfg = get_config(arch, reduced=True).replace(dtype="float32", **change)
    params = init_params(cfg, seed=5, device="cpu")
    x = torch.randn((3, 40, cfg.d_model), generator=gen, device="cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cuda = {k: v.cuda() for k, v in params.items()}
        y, aux = moe.apply_moe(Block(cuda, "layers/", 0), x, cfg)
        e = moe.route(cuda["layers/moe/router"][0],
                      x.reshape(-1, cfg.d_model), cfg.top_k)[1]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    y2, aux2 = moe.apply_moe(Block(params, "layers/", 0), x.cpu(), cfg)
    e2 = moe.route(params["layers/moe/router"][0],
                   x.cpu().reshape(-1, cfg.d_model), cfg.top_k)[1]
    assert torch.equal(e.cpu(), e2)
    torch.testing.assert_close(y.cpu(), y2, atol=1e-5, rtol=0)
    torch.testing.assert_close(aux.cpu(), aux2, atol=1e-6, rtol=0)


def _grouped_rows(gen, E, M, K, N, dtype):
    """Rows (M, K) sorted into E groups of seeded sizes (some empty), a
    stack (E, K, N) and the int32 cumulative group sizes, on the card."""
    ids = torch.randint(0, E, (M,), generator=gen, device="cuda")
    ids = torch.where(ids % 7 == 1, ids - 1, ids)   # experts 1, 8, ... empty
    offs = torch.cumsum(torch.bincount(ids, minlength=E), 0).to(torch.int32)
    x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((E, K, N), generator=gen, device="cuda")
         * K ** -0.5).to(dtype)
    return x, w, offs


def _plain_grouped(x, w, offs):
    bounds, lo, outs = offs.tolist(), 0, []
    for e, hi in enumerate(bounds):
        outs.append(x[lo:hi] @ w[e])
        lo = hi
    return torch.cat(outs)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b"])
def test_grouped_product_on_card_meets_the_plain_one(gen, arch, dtype):
    """``models.moe.grouped_mm`` at the arch's widths (gate/up d -> f and
    down f -> d, its E experts, 2,048 tokens x top-k rows with empty
    groups) against a loop of per-expert products on the same rows, TF32
    off.  bf16 takes ``torch._grouped_mm``: within 1e-2 of the plain
    result's largest value (bf16 outputs of fp32 sums; the probe on the
    H100 measured 1.6e-2 absolute at |y| ~5.6 against an fp32 loop); fp32
    takes the plain loop (equal bits), and ``torch._grouped_mm`` in fp32
    meets it within 1e-5."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(arch)
    dt = getattr(torch, dtype)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for K, N in ((cfg.d_model, cfg.moe_d_ff), (cfg.moe_d_ff, cfg.d_model)):
            x, w, offs = _grouped_rows(gen, cfg.n_experts,
                                       2048 * cfg.top_k, K, N, dt)
            want = _plain_grouped(x, w, offs)
            got = moe.grouped_mm(x, w, offs)
            if dtype == "bfloat16":
                assert moe.grouped_route(x, w) == "torch._grouped_mm"
                scale = float(want.float().abs().max())
                assert float((got.float() - want.float()).abs().max()) \
                    <= 1e-2 * scale
            else:
                assert moe.grouped_route(x, w) == "plain"
                assert torch.equal(got, want)
                lib = torch._grouped_mm(x, w, offs=offs)
                torch.testing.assert_close(lib, want, atol=1e-5, rtol=0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b"])
def test_expert_shares_on_card_sum_to_the_whole(gen, arch):
    """``models.moe.expert_rows`` on one model rank's share of the experts
    (what a rank of a 4-wide model axis runs where the experts split
    there: its own experts' rows sorted first, the rows past its last
    group masked), bf16 through ``torch._grouped_mm``, summed over the 4
    shares, against the whole stack at the arch's widths (512 tokens,
    routed by the arch's router, which requires grad, so x's gradient
    also flows through the routing): the output, x's and the router's
    gradients within 2e-2 of the whole's largest (bf16 rounding of the
    partial sums), every share's output and its x, router and weight
    gradients finite (the grouped product leaves the rows past its last
    group unwritten)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params_on_device, moe
    cfg = get_config(arch).replace(n_layers=1)
    params = init_params_on_device(cfg, seed=4, device="cuda")
    E = cfg.n_experts
    x = torch.randn((512, cfg.d_model), generator=gen,
                    device="cuda").bfloat16()
    router = params["layers/moe/router"][0]
    ws = [params[f"layers/moe/{n}"][0] for n in ("w_gate", "w_up", "w_down")]
    ct = torch.randn(x.shape, generator=gen, device="cuda").bfloat16()

    def run(first, n):
        xl = x.detach().requires_grad_(True)
        rl = router.detach().requires_grad_(True)
        wl = [w[first:first + n].detach().requires_grad_(True) for w in ws]
        weights, experts, _ = moe.route(rl, xl, cfg.top_k)
        y = moe.expert_rows(xl, weights, experts, *wl, E, first)
        (y.float() * ct.float()).sum().backward()
        for t in (y, xl.grad, rl.grad, *(w.grad for w in wl)):
            assert bool(torch.isfinite(t).all()), (arch, first)
        return y.detach().float(), xl.grad.float(), rl.grad.float()
    whole = run(0, E)
    n = E // 4
    parts = [run(r * n, n) for r in range(4)]
    for i, want in enumerate(whole):
        got = sum(p[i] for p in parts)
        assert float((got - want).abs().max()) \
            <= 2e-2 * float(want.abs().max()), (arch, i)


def test_ragged_dispatch_on_card_repeats_its_bits(gen):
    """``apply_moe(impl="ragged")`` at Qwen2-MoE's widths (one layer, bf16
    weights made on the card, 512 tokens): two runs give the same bits
    (the scatter back is a gather and adds in a fixed order, no atomics);
    in fp32 (TF32 off) it meets ``dense_scan`` within 1e-5."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params_on_device, moe
    from repro_torch.models.model import Block
    cfg = get_config("qwen2-moe-a2.7b").replace(n_layers=1)
    params = init_params_on_device(cfg, seed=3, device="cuda")
    blk = Block(params, "layers/", 0)
    x = torch.randn((2, 256, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    y1, a1 = moe.apply_moe(blk, x, cfg, impl="ragged")
    y2, a2 = moe.apply_moe(blk, x, cfg, impl="ragged")
    assert torch.equal(y1, y2) and torch.equal(a1, a2)
    del params, blk
    small = get_config("qwen2-moe-a2.7b", reduced=True).replace(
        dtype="float32", n_experts=16, top_k=4)
    p32 = init_params_on_device(small, seed=4, device="cuda")
    b32 = Block(p32, "layers/", 0)
    x32 = torch.randn((3, 40, small.d_model), generator=gen, device="cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yr, ar = moe.apply_moe(b32, x32, small, impl="ragged")
        yd, ad = moe.apply_moe(b32, x32, small)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.testing.assert_close(yr, yd, atol=1e-5, rtol=0)
    torch.testing.assert_close(ar, ad, atol=0, rtol=0)


@pytest.mark.parametrize("arch", ["internvl2-26b", "seamless-m4t-large-v2"])
def test_zoo_model_path_on_card_equals_cpu(gen, arch):
    """The reduced InternVL2 and SeamlessM4T in fp32 (TF32 off) through the
    model-level path on the card (the kernels) against the CPU (their
    plain versions) on the same weights and inputs: the train logits, the
    prefill logits at each row's last valid token of a right-padded batch,
    and four decode steps from it (seeded tokens), each within 5e-5 (the CPU tests'
    allowance against JAX); an encoder-decoder's cross rings unchanged by
    the steps."""
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, forward, init_params,
                                    mask_padded_positions)
    cfg = get_config(arch, reduced=True).replace(dtype="float32")
    params = init_params(cfg, seed=5, device="cpu")
    g = torch.Generator().manual_seed(3)
    B, S = 2, 40
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    if cfg.frontend == "vision_patches":
        batch["patches"] = torch.randn((B, cfg.n_frontend_tokens,
                                        cfg.d_model), generator=g)
    else:
        batch["frames"] = torch.randn((B, 48, cfg.d_model), generator=g)
    last = torch.tensor([S - 1, 17], dtype=torch.int32)
    new = torch.randint(0, cfg.vocab_size, (4, B, 1), generator=g)

    def run(dev):
        p = {k: v.to(dev) for k, v in params.items()}
        b = {k: v.to(dev) for k, v in batch.items()}
        with torch.no_grad():
            train = forward(p, cfg, b, mode="train")["logits"].cpu()
            pre = forward(p, cfg, b, mode="prefill", cache_width=96,
                          last_index=last.to(dev))
            off = pre["text_offset"]
            cache = mask_padded_positions(pre["cache"], last.to(dev) + off)
            cross0 = [t.clone() for t in cache.get("cross", ())]
            outs = [pre["logits"].cpu()]
            step = last.to(dev) + off + 1
            for tok in new.to(dev):
                d = decode_step(p, cfg, cache, {"tokens": tok}, step)
                outs.append(d["logits"].cpu())
                step = step + 1
        assert all(torch.equal(a, b) for a, b in zip(cross0,
                                                     cache.get("cross", ())))
        return train, outs
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        from repro_torch.kernels import ops as kops
        kops.reset_launch_counts()
        card = run("cuda")
        counts = kops.launch_counts()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu = run("cpu")
    assert counts["flash_attention"] > 0 and counts["paged_decode_attention"] > 0
    torch.testing.assert_close(card[0], cpu[0], atol=5e-5, rtol=0)
    for a, b in zip(card[1], cpu[1]):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=0)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b"])
def test_moe_engine_ring_equals_paged_on_card(gen, arch):
    """The reduced MoE LMs in bf16 on the card (weights made there by
    ``init_params_on_device``), injected uniforms: the paged engine's
    tokens, and the paged engine's with 32-token chunked prefill, equal
    the ring engine's bit for bit; 2 flash launches an admission batch, 2
    paged a tick, no ``tte_sample``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params_on_device
    from repro_torch.serve import BatchedEngine, Request
    cfg = get_config(arch, reduced=True)
    params = init_params_on_device(cfg, seed=3, device="cuda")
    rng = np.random.default_rng(1)
    prompts = [(rng.integers(0, cfg.vocab_size, S).astype(np.int32),
                rng.random((10, cfg.vocab_size), dtype=np.float32))
               for S in (5, 20, 33, 70, 90, 120)]
    outs = []
    for kw in ({}, {"cache": "paged"},
               {"cache": "paged", "prefill_chunk_tokens": 32}):
        eng = BatchedEngine(params, cfg, slots=3, max_context=256,
                            device="cuda", **kw)
        reqs = [Request(tokens=t, max_new=10, uniforms=u)
                for t, u in prompts]
        for r in reqs:
            eng.submit(r)
        ops.reset_launch_counts()
        eng.run()
        counts = ops.launch_counts()
        assert all(r.done and r.error is None and len(r.out_tokens) == 10
                   for r in reqs)
        assert eng.host_syncs == eng.ticks + eng.admit_batches
        assert counts["paged_decode_attention"] == 2 * eng.ticks
        assert counts["tte_sample"] == 0
        if "prefill_chunk_tokens" not in kw:
            assert counts["flash_attention"] == 2 * eng.admit_batches
        outs.append([r.out_tokens for r in reqs])
    assert outs[0] == outs[1] == outs[2]


def test_fork_bit_identical_to_oracle_on_card(gen):
    """bf16 on the card: ``sample_futures`` on the ring, on the paged
    engine and twice on the prefix-cached paged engine equals the port's
    ``ring_reference_futures`` bit for bit."""
    import numpy as np
    from repro_torch.serve import BatchedEngine, ring_reference_futures
    params, cfg = _delphi_bf16()
    toks = np.asarray([3, 10, 20, 30, 41, 7, 9, 11, 13, 17, 19, 23, 29, 31,
                       37, 43, 47, 53], np.int32)
    ages = np.linspace(0.0, 30.0, len(toks)).astype(np.float32)
    n, max_new = 4, 6
    u = np.random.default_rng(1).random((n, max_new, cfg.vocab_size),
                                        dtype=np.float32)
    ora = ring_reference_futures(params, cfg, toks, ages, n=n,
                                 max_new=max_new, uniforms=u, slots=4,
                                 max_context=64, device="cuda")
    for kw, rounds in (({}, 1), ({"cache": "paged", "block_size": 16}, 1),
                       ({"cache": "paged", "block_size": 16,
                         "prefix_cache": True}, 2)):
        eng = BatchedEngine(params, cfg, slots=4, max_context=64,
                            device="cuda", **kw)
        for _ in range(rounds):
            kids = eng.sample_futures(toks, ages, n=n, max_new=max_new,
                                      uniforms=u)
            assert [(k.out_tokens, k.out_ages) for k in kids] == ora
        if eng.paged:
            eng.drop_prefix_cache()
            assert eng.allocator.used == 0 and not eng.pool._refs


def test_chunked_engine_bit_identical_to_oracle_on_card(gen):
    """bf16 on the card, injected uniforms: the unchunked paged engine ==
    ``chunked_reference_trajectory`` at an unbounded budget, the chunked
    engine at one block and at 64 tokens == the oracle at that budget, a
    partial prefix hit == the oracle with ``matched_tokens``; a fork from
    a parent prefilled in one chunk == the unchunked fork, and each future
    of a fork from a parent prefilled in three chunks == the oracle on its
    uniforms, bit for bit."""
    import numpy as np
    from repro_torch.serve import (BatchedEngine, Request,
                                   chunked_reference_trajectory)
    params, cfg = _delphi_bf16()
    rng = np.random.default_rng(2)
    geo = dict(slots=4, max_context=64, block_size=16)

    def serve(toks, ages, u, max_new, eng=None, **kw):
        eng = eng or BatchedEngine(params, cfg, cache="paged", device="cuda",
                                   **geo, **kw)
        r = Request(tokens=toks, ages=ages, max_new=max_new, uniforms=u)
        eng.submit(r)
        eng.run()
        assert r.done and r.error is None
        assert eng.host_syncs == eng.ticks + eng.admit_batches
        return (r.out_tokens, r.out_ages), eng

    def oracle(toks, ages, u, max_new, chunk, matched=0):
        return chunked_reference_trajectory(
            params, cfg, toks, ages, max_new=max_new, uniforms=u,
            chunk_tokens=chunk, matched_tokens=matched, device="cuda", **geo)

    for S in (5, 21, 40):
        toks = (np.arange(3, 3 + S) % 90).astype(np.int32)
        ages = np.linspace(0.0, 30.0, S).astype(np.float32)
        u = rng.random((8, cfg.vocab_size), dtype=np.float32)
        assert serve(toks, ages, u, 8)[0] == oracle(toks, ages, u, 8, 64)
        for budget in (16, 64):
            got, eng = serve(toks, ages, u, 8, prefill_chunk_tokens=budget)
            assert got == oracle(toks, ages, u, 8, budget), (S, budget)
            assert eng.allocator.used == 0
    # a partial hit: a registrant of one block, then a prompt extending it
    toks = (np.arange(3, 43) % 90).astype(np.int32)
    ages = np.linspace(0.0, 30.0, 40).astype(np.float32)
    u = rng.random((2, 8, cfg.vocab_size), dtype=np.float32)
    _, eng = serve(toks[:16], ages[:16], u[0], 8, prefix_cache=True,
                   prefill_chunk_tokens=16)
    got, eng = serve(toks, ages, u[1], 8, eng=eng)
    assert eng.pool_stats()["suffix_tokens_saved"] == 16
    assert got == oracle(toks, ages, u[1], 8, 16, matched=16)
    # forks from chunk-prefilled parents: one chunk (64 >= 40), three (16)
    fu = rng.random((3, 6, cfg.vocab_size), dtype=np.float32)

    def futures(**kw):
        eng = BatchedEngine(params, cfg, cache="paged", device="cuda",
                            **geo, **kw)
        kids = eng.sample_futures(toks, ages, n=3, max_new=6, uniforms=fu)
        return [(k.out_tokens, k.out_ages) for k in kids]
    assert futures(prefill_chunk_tokens=64) == futures()
    want = [chunked_reference_trajectory(
        params, cfg, toks, ages, max_new=6, uniforms=fu[j], chunk_tokens=16,
        device="cuda", **geo) for j in range(3)]
    assert futures(prefill_chunk_tokens=16) == want


def _ssd_inputs(gen, b, C, Q, H, P, N, dtype, *, shared_bc=False,
                bc_dtype=None, step=0.2):
    """SSD tiles as tests/test_kernels.py draws them: N(0, 1) inputs and a
    decreasing cum (dt*A of U(0, ``step``) steps); with ``shared_bc`` B and
    C are one tile per batch row broadcast over the heads by a 0 stride.
    B and C are in ``bc_dtype`` (default: ``dtype``)."""
    def rnd(*shape, dt=dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)
    xdt = rnd(b, C, Q, H, P)
    hb = 1 if shared_bc else H
    bc = bc_dtype or dtype
    Bm = rnd(b, C, Q, hb, N, dt=bc).expand(b, C, Q, H, N)
    Cm = rnd(b, C, Q, hb, N, dt=bc).expand(b, C, Q, H, N)
    cum = -torch.cumsum(step * torch.rand((b, C, Q, H), generator=gen,
                                          device="cuda"), dim=2)
    return xdt, Bm, Cm, cum


@pytest.mark.parametrize("BH,C,Q,P,N,dtype", [
    (1, 1, 16, 8, 8, torch.float32),
    (4, 3, 32, 16, 32, torch.float32),
    (2, 2, 128, 64, 128, torch.float32),     # production tile
    (2, 2, 64, 32, 64, torch.bfloat16),
    (2, 3, 32, 32, 16, torch.float32),       # reduced mamba2
])
def test_ssd_intra_kernel_vs_plain(gen, BH, C, Q, P, N, dtype):
    xdt, Bm, Cm, cum = (t[:, :, :, 0] for t in
                        _ssd_inputs(gen, BH, C, Q, 1, P, N, dtype))
    n0 = sk.launches
    y, st = ops.ssd_intra(xdt, Bm, Cm, cum)
    assert sk.launches == n0 + 1
    assert y.dtype == st.dtype == torch.float32
    yr, sr = ref.ssd_intra_ref(xdt, Bm, Cm, cum)
    torch.testing.assert_close(y, yr, atol=1e-4, rtol=0)
    torch.testing.assert_close(st, sr, atol=1e-4, rtol=0)


def test_ssd_intra_kernel_main_path_tile_with_shared_bc(gen):
    """Mamba2-780M at a 1024-token prompt: 8 chunks x 48 heads, fp32 xdt and
    bf16 B/C read once per batch row through a stride-0 head axis."""
    xdt, Bm, Cm, cum = _ssd_inputs(gen, 1, 8, 128, 48, 64, 128,
                                   torch.float32, shared_bc=True,
                                   bc_dtype=torch.bfloat16)
    assert Bm.stride(3) == 0 and Bm.dtype == torch.bfloat16
    y, st = ops.ssd_intra_heads(xdt, Bm, Cm, cum)
    yr, sr = ref.ssd_intra_ref(xdt.transpose(2, 3), Bm.transpose(2, 3),
                               Cm.transpose(2, 3), cum.transpose(2, 3))
    torch.testing.assert_close(y, yr.transpose(2, 3), atol=1e-4, rtol=0)
    torch.testing.assert_close(st, sr, atol=1e-4, rtol=0)


def test_ssd_intra_kernel_zamba2_tile_with_shared_bc(gen):
    """Zamba2-1.2B at a 1024-token prompt: 8 chunks x 64 heads at N 64, fp32
    xdt and bf16 B/C read once per batch row through a stride-0 head
    axis."""
    xdt, Bm, Cm, cum = _ssd_inputs(gen, 1, 8, 128, 64, 64, 64,
                                   torch.float32, shared_bc=True,
                                   bc_dtype=torch.bfloat16)
    n0 = sk.launches
    y, st = ops.ssd_intra_heads(xdt, Bm, Cm, cum)
    assert sk.launches == n0 + 1
    yr, sr = ref.ssd_intra_ref(xdt.transpose(2, 3), Bm.transpose(2, 3),
                               Cm.transpose(2, 3), cum.transpose(2, 3))
    torch.testing.assert_close(y, yr.transpose(2, 3), atol=1e-4, rtol=0)
    torch.testing.assert_close(st, sr, atol=1e-4, rtol=0)


@pytest.mark.parametrize("k,n", [(11008, 4096), (5120, 1024),
                                 (27648, 5120), (2048, 256)],
                         ids=["deepseek-7b-down", "qwen2.5-32b-kv",
                              "qwen2.5-32b-down", "tinyllama-kv"])
def test_prefill_products_do_not_depend_on_the_row_count(gen, k, n):
    """bf16 products at the zoo's shapes where cuBLAS, given PyTorch's
    default workspace, splits the reduction over K at some row counts:
    through ``row_products`` in a prefill's ``PREFILL_ROWS``-row pieces,
    each row of a monolithic prefill's bucket (164 tokens in 256 rows, 768
    in 1,024) has the bits that a chunked prefill gives it, 64 or 16
    columns a chunk, the last one ragged."""
    w = (torch.randn((k, n), generator=gen, device="cuda")
         / k ** 0.5).to(torch.bfloat16)
    for S, bucket in ((164, 256), (768, 1024)):
        x = torch.randn((1, bucket, k), generator=gen,
                        device="cuda").to(torch.bfloat16)
        whole = row_products(x, w, PREFILL_ROWS)[0, :S]
        for width in (64, 16):
            chunks = torch.cat([
                row_products(x[:, c:c + width], w, PREFILL_ROWS)[0]
                for c in range(0, S, width)])[:S]
            assert torch.equal(whole, chunks), (S, bucket, width)


@pytest.mark.parametrize("shared_bc", [False, True],
                         ids=["per-head-bc", "stride-0-bc"])
@pytest.mark.parametrize("H,N", [(48, 128), (64, 64)],
                         ids=["mamba2-780m", "zamba2-1.2b"])
def test_ssd_intra_heads_kernel_vs_heads_ref(gen, H, N, shared_bc):
    """``ops.ssd_intra_heads`` (the model's layout, one launch) against
    ``ref.ssd_intra_heads_ref`` on the same inputs at a 1024-token prompt
    (8 chunks of 128), with B/C per head in fp32 or read once per batch
    row through a stride-0 head axis in bf16; atol 1e-4."""
    bc_dtype = torch.bfloat16 if shared_bc else torch.float32
    xdt, Bm, Cm, cum = _ssd_inputs(gen, 1, 8, 128, H, 64, N, torch.float32,
                                   shared_bc=shared_bc, bc_dtype=bc_dtype)
    n0 = sk.launches
    y, st = ops.ssd_intra_heads(xdt, Bm, Cm, cum)
    assert sk.launches == n0 + 1
    yr, sr = ref.ssd_intra_heads_ref(xdt, Bm, Cm, cum)
    assert y.shape == yr.shape and st.shape == sr.shape
    torch.testing.assert_close(y, yr, atol=1e-4, rtol=0)
    torch.testing.assert_close(st, sr, atol=1e-4, rtol=0)


@pytest.mark.parametrize("C", [1, 8], ids=["96-tokens", "1024-tokens"])
@pytest.mark.parametrize("H,N", [(48, 128), (64, 64)],
                         ids=["mamba2-780m", "zamba2-1.2b"])
def test_ssd_intra_operator_equals_the_wrapper(gen, H, N, C):
    """``repro_torch::ssd_intra`` (the artifact's graphs call it) launches
    the kernel once through the wrapper and gives its bits, at 3b's and
    3o's prefill shapes: one or 8 chunks of 128, fp32 xdt, bf16 B/C read
    once per batch row through a stride-0 head axis."""
    from repro_torch.kernels import library
    xdt, Bm, Cm, cum = _ssd_inputs(gen, 1, C, 128, H, 64, N, torch.float32,
                                   shared_bc=True, bc_dtype=torch.bfloat16)
    y0, s0 = sk.ssd_intra_cuda(xdt, Bm, Cm, cum)
    n0 = sk.launches
    y1, s1 = library.ssd_intra(xdt, Bm, Cm, cum)
    assert sk.launches == n0 + 1
    assert torch.equal(y0, y1) and torch.equal(s0, s1)


@pytest.mark.parametrize("H,N", [(48, 128), (64, 64)],
                         ids=["mamba2-780m", "zamba2-1.2b"])
def test_ssd_intra_operator_fake_is_the_cuda_output(gen, H, N):
    """The operator's fake implementation (what ``torch.export`` traces)
    gives the CUDA output's shapes, dtypes and strides."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import library
    args = _ssd_inputs(gen, 1, 8, 128, H, 64, N, torch.float32,
                       shared_bc=True, bc_dtype=torch.bfloat16)
    real = library.ssd_intra(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = library.ssd_intra(*[mode.from_tensor(a) for a in args])
    for f, r in zip(fake, real):
        assert (f.shape, f.dtype, f.stride(), f.device) == \
            (r.shape, r.dtype, r.stride(), r.device)


@pytest.mark.parametrize("H,N", [(48, 128), (64, 64)],
                         ids=["mamba2-780m", "zamba2-1.2b"])
def test_plain_ssd_route_equals_kernel_route_on_card(gen, H, N):
    """The training route's plain SSD (``ssd_chunked(...,
    differentiable=True)``) against the kernel route at full width and
    1024 tokens: x fp32, dt ~ 0.01 (the init's), bf16 B/C; ``y`` and the
    final state within 1e-4."""
    from repro_torch.models import ssm as ssm_lib
    S, P, Q = 1024, 64, 128
    x = torch.randn((1, S, H, P), generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(
        0.5 * torch.randn((1, S, H), generator=gen, device="cuda")
        + float(np.log(np.expm1(np.float32(0.01)))))
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    Bm, Cm = (0.5 * torch.randn((1, S, N), generator=gen, device="cuda")
              for _ in range(2))
    Bm, Cm = Bm.to(torch.bfloat16), Cm.to(torch.bfloat16)
    n0 = sk.launches
    with torch.no_grad():
        yk, hk = ssm_lib.ssd_chunked(x, dt, A, Bm, Cm, Q)
        yp, hp = ssm_lib.ssd_chunked(x, dt, A, Bm, Cm, Q,
                                     differentiable=True)
    assert sk.launches == n0 + 1
    torch.testing.assert_close(yp, yk, atol=1e-4, rtol=0)
    torch.testing.assert_close(hp, hk, atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,C,H,bc_dtype,shared,step", [
    (1, 1, 48, torch.bfloat16, True, 0.2),    # one-chunk main tile
    (2, 2, 4, torch.bfloat16, False, 0.2),    # bf16 B/C per head
    (1, 2, 8, torch.bfloat16, True, 2.0),     # steep decay: L underflows
    (2, 2, 8, torch.float32, True, 0.2),      # fp32 B/C shared by the heads
], ids=["one-chunk-main", "bf16-per-head", "steep-decay", "fp32-shared"])
def test_ssd_intra_kernel_heads_layout(gen, b, C, H, bc_dtype, shared, step):
    """Q 128, P 64, N 128 with fp32 xdt in the model's layout: each route of
    the kernel (tensor cores for bf16 B/C, shared or per head; CUDA cores
    for fp32 B/C) held to 1e-4, with no NaN where L underflows to 0."""
    xdt, Bm, Cm, cum = _ssd_inputs(gen, b, C, 128, H, 64, 128, torch.float32,
                                   shared_bc=shared, bc_dtype=bc_dtype,
                                   step=step)
    assert (Bm.stride(3) == 0) == shared
    n0 = sk.launches
    y, st = ops.ssd_intra_heads(xdt, Bm, Cm, cum)
    assert sk.launches == n0 + 1
    assert bool(y.isfinite().all()) and bool(st.isfinite().all())
    yr, sr = ref.ssd_intra_ref(xdt.transpose(2, 3), Bm.transpose(2, 3),
                               Cm.transpose(2, 3), cum.transpose(2, 3))
    torch.testing.assert_close(y, yr.transpose(2, 3), atol=1e-4, rtol=0)
    torch.testing.assert_close(st, sr, atol=1e-4, rtol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = torch.randn((2, 8), generator=gen, device="cuda")
    with pytest.raises(TypeError):
        tk.tte_sample_cuda(x.double(), x.double())
    q = torch.randn((1, 2, 8, 130), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fk.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_attention_cuda(q.cpu(), q.cpu(), q.cpu())
    xdt, Bm, Cm, cum = _ssd_inputs(gen, 1, 1, 32, 2, 8, 8, torch.float32)
    with pytest.raises(ValueError, match="Q in"):       # no 48-row tile
        sk.ssd_intra_cuda(xdt[:, :, :24], Bm[:, :, :24], Cm[:, :, :24],
                          cum[:, :, :24])
    with pytest.raises(TypeError):
        sk.ssd_intra_cuda(xdt.double(), Bm, Cm, cum)
    with pytest.raises(TypeError):
        sk.ssd_intra_cuda(xdt, Bm, Cm, cum.to(torch.bfloat16))
    strided = torch.zeros((1, 1, 32, 2, 16), device="cuda")[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        sk.ssd_intra_cuda(strided, Bm, Cm, cum)


# ---------------------------------------------------------------------------
# The serving surface on the card: the background loop, HTTP, /v1/risk
# ---------------------------------------------------------------------------
def _long_uniforms(rng, max_new, cfg):
    u = rng.random((max_new, cfg.vocab_size), dtype=np.float32)
    u[:, cfg.death_token] = 1e-12
    return u


def test_bf16_server_remote_equals_twin_on_card(gen):
    """bf16 on the card, one request at a time, injected uniforms: a fresh
    server's ``/v1/generate`` equals an in-process twin engine's generate
    bit for bit (tokens and fp32 ages), and ``/v1/stream`` equals it."""
    from repro_torch.api import Client
    from repro_torch.api.client import EngineBackend
    from repro_torch.serve.server import InferenceServer
    params, cfg = _delphi_bf16()
    kw = dict(slots=4, max_context=64, cache="paged", prefix_cache=True,
              device="cuda")
    server = InferenceServer(EngineBackend.create(params, cfg, **kw),
                             port=0).start()
    try:
        remote = Client.connect(server.address)
        twin = Client.serving(params, cfg, **kw)
        rng = np.random.default_rng(3)
        for S in (3, 9, 21):
            toks = (np.arange(3, 3 + S) % 90).tolist()
            ages = np.linspace(0.0, 30.0, S).astype(np.float32).tolist()
            u = rng.random((8, cfg.vocab_size), dtype=np.float32)
            r = remote.generate(tokens=toks, ages=ages, max_new=8,
                                uniforms=u)
            w = twin.generate(tokens=toks, ages=ages, max_new=8, uniforms=u)
            assert len(r.tokens) > 0
            assert (r.tokens, r.ages) == (w.tokens, w.ages)
            evs = list(remote.stream(tokens=toks, ages=ages, max_new=8,
                                     uniforms=u))
            assert [(e.token, e.age) for e in evs] == list(zip(r.tokens,
                                                               r.ages))
    finally:
        server.stop()


def test_background_futures_equal_oracle_on_card(gen):
    from repro_torch.serve import BatchedEngine, ring_reference_futures
    params, cfg = _delphi_bf16()
    toks = (np.arange(3, 3 + 37) % 90).astype(np.int32)
    ages = np.linspace(0.0, 30.0, len(toks)).astype(np.float32)
    u = np.random.default_rng(4).random((4, 6, cfg.vocab_size),
                                        dtype=np.float32)
    ora = ring_reference_futures(params, cfg, toks, ages, n=4, max_new=6,
                                 uniforms=u, slots=4, max_context=64,
                                 device="cuda")
    eng = BatchedEngine(params, cfg, slots=4, max_context=64, cache="paged",
                        prefix_cache=True, device="cuda").start()
    try:
        for _ in range(2):
            kids = eng.sample_futures(toks, ages, n=4, max_new=6,
                                      uniforms=u, wait_timeout=120.0)
            assert all(k.error is None for k in kids)
            assert [(k.out_tokens, k.out_ages) for k in kids] == ora
    finally:
        eng.stop()
    assert eng.prefix.hits >= 1


def test_risk_logits_during_ticks_equal_a_quiet_engine(gen):
    """The loop's thread ticks while this thread runs ``EngineBackend
    .logits`` (``/v1/risk``'s forward): both launch on the default stream,
    so the logits equal those of a quiet engine bit for bit, and the
    ticking requests equal a foreground run's."""
    import threading
    from repro_torch.api.client import EngineBackend
    from repro_torch.serve import Request
    params, cfg = _delphi_bf16()
    kw = dict(slots=4, max_context=64, device="cuda")
    quiet = EngineBackend.create(params, cfg, **kw)
    busy = EngineBackend.create(params, cfg, **kw)
    rng = np.random.default_rng(5)
    prompts = [((np.arange(3, 3 + S) % 90).astype(np.int32),
                np.linspace(0.0, 30.0, S).astype(np.float32),
                _long_uniforms(rng, 40, cfg)) for S in (4, 7, 12, 20)]
    asks = [((np.arange(5, 5 + S) % 90).tolist(),
             np.linspace(1.0, 20.0, S).astype(np.float32).tolist())
            for S in (2, 6, 11)]
    want = [quiet.logits(t, a) for t, a in asks]
    fg = [Request(tokens=t, ages=a, max_new=40, uniforms=u)
          for t, a, u in prompts]
    for r in fg:
        quiet.engine.submit(r)
    quiet.engine.run()
    done = threading.Semaphore(0)
    bg = [Request(tokens=t, ages=a, max_new=40, uniforms=u,
                  on_done=lambda _r: done.release()) for t, a, u in prompts]
    busy.engine.start()
    try:
        for r in bg:
            busy.engine.submit(r)
        rounds = 0
        while any(not r.done for r in bg) or rounds < 3:
            for (t, a), w in zip(asks, want):
                assert np.array_equal(busy.logits(t, a), w)
            rounds += 1
        for _ in bg:
            assert done.acquire(timeout=120.0)
    finally:
        busy.engine.stop()
    assert busy.engine.ticks > 0
    assert [(r.error, r.out_tokens, r.out_ages) for r in bg] == \
        [(None, r.out_tokens, r.out_ages) for r in fg]


# ---------------------------------------------------------------------------
# Training and the cohort sweep on the card
# ---------------------------------------------------------------------------
def _grad_calls(dev):
    """One call of each kernel entry point with inputs that require grad."""
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def t(*shape, grad=True):
        return torch.randn(shape, generator=g, device=dev).requires_grad_(grad)
    table = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    pos = torch.arange(8, dtype=torch.int32, device=dev)[None].repeat(2, 1)
    step = torch.tensor([7, 7], device=dev)
    return {
        "flash_attention": lambda: ops.flash_attention(
            t(1, 2, 4, 8), t(1, 2, 4, 8), t(1, 2, 4, 8)),
        "suffix_prefill_attention": lambda: ops.suffix_prefill_attention(
            t(1, 2, 2, 8), t(1, 2, 2, 8), t(1, 2, 2, 8), t(1, 3, 2, 8),
            t(1, 3, 2, 8), torch.tensor([[3, 4]], device=dev),
            torch.tensor([[0, 1, 2]], device=dev)),
        "paged_decode_attention": lambda: ops.paged_decode_attention(
            t(2, 2, 8), t(2, 2, 8, 8), t(2, 2, 8, 8), table, pos, step),
        "tte_sample": lambda: ops.tte_sample(
            t(2, 16), torch.rand((2, 16), generator=g, device=dev)),
        "ssd_intra_heads": lambda: ops.ssd_intra_heads(
            t(1, 1, 32, 2, 16), t(1, 1, 32, 2, 16), t(1, 1, 32, 2, 16),
            -torch.rand((1, 1, 32, 2), generator=g, device=dev).cumsum(2)),
    }


@pytest.mark.parametrize("name", ["flash_attention",
                                  "suffix_prefill_attention",
                                  "paged_decode_attention", "tte_sample",
                                  "ssd_intra_heads"])
def test_kernel_entry_points_refuse_grad_on_card(gen, name):
    """No kernel has a backward: under grad each entry point raises on the
    card as on the CPU, before it launches; without grad it launches."""
    call = _grad_calls("cuda")[name]
    before = dict(ops.launch_counts())
    with pytest.raises(RuntimeError, match="has no backward"):
        call()
    assert ops.launch_counts() == before
    with torch.no_grad():
        call()
    torch.cuda.synchronize()


def test_train_step_on_card_equals_cpu(gen):
    """fp32 with TF32 off: one train step's loss and every gradient on the
    card against the CPU port's on the same batch (reduced Delphi-2M with
    its 1289 events).  The two differ only in summation order and the
    libraries' sin/cos of the age angles (the frequency table is the same
    bits): loss within 1e-5 relative, each gradient within 1e-3 of its
    leaf's largest element; none is missing or all-zero."""
    from repro_torch.configs import get_config
    from repro_torch.data import (SimulatorConfig, generate_dataset,
                                  pack_trajectories)
    from repro_torch.models import init_params
    from repro_torch.train import (OptimizerConfig, init_opt_state,
                                   loss_and_grads, make_loss_fn,
                                   make_train_step)
    from repro_torch.train.trainer import to_device
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_config("delphi-2m", reduced=True).replace(
            dtype="float32", vocab_size=1289)
        host = init_params(cfg, seed=3, device="cpu")
        card = {k: v.cuda() for k, v in host.items()}
        trajs, _ = generate_dataset(SimulatorConfig(n_train=16, n_val=1,
                                                    seed=3))
        batch = pack_trajectories(trajs, 64)
        loss_fn = make_loss_fn(cfg, "delphi")
        n0 = dict(ops.launch_counts())
        g_card, m_card = loss_and_grads(loss_fn, card,
                                        to_device(batch, "cuda"))
        assert ops.launch_counts() == n0        # no kernel on the route
        g_cpu, m_cpu = loss_and_grads(loss_fn, host, to_device(batch, "cpu"))
        torch.testing.assert_close(m_card["loss"].cpu(), m_cpu["loss"],
                                   rtol=1e-5, atol=0)
        for k in g_cpu:
            g = g_card[k].cpu()
            scale = float(g_cpu[k].abs().max())
            assert bool(torch.isfinite(g).all()) and scale > 0
            assert float(g.abs().max()) > 0, k
            assert float((g - g_cpu[k]).abs().max()) <= 1e-3 * scale, k
        new, state, m = make_train_step(cfg, OptimizerConfig(), "delphi")(
            card, init_opt_state(card), to_device(batch, "cuda"))
        assert int(state["step"]) == 1
        assert all(bool(torch.isfinite(v).all()) and not v.requires_grad
                   for v in new.values())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32



def test_load_checkpoint_on_card_in_use_dtypes(gen, tmp_path):
    """Reduced OLMoE-1B-7B (6 layers) in fp32, saved from the card by the
    port's ``save`` and read back by ``load_checkpoint`` onto the card
    under the bf16 config: every leaf on the card in its use dtype, equal
    to ``init_params_on_device`` in bf16 (the same draws rounded), and the
    load's peak allocation within the tree and one fp32 piece (a layer
    slice or an unstacked leaf) plus 1 MiB of allocator rounding, not the
    fp32 tree beside a cast copy."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.models import init_params_on_device, load_checkpoint
    from repro_torch.models.params import STACKS, param_shapes, use_dtype
    from repro_torch.train import checkpoint
    cfg = get_config("olmoe-1b-7b", reduced=True).replace(n_layers=6)
    checkpoint.save(str(tmp_path), init_params_on_device(
        cfg.replace(dtype="float32"), seed=4, device="cuda"), cfg)
    want = init_params_on_device(cfg, seed=4, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = load_checkpoint(str(tmp_path), cfg, device="cuda")
    peak = torch.cuda.max_memory_allocated() - base
    tree = sum(v.numel() * v.element_size() for v in got.values())
    piece = 4 * max(math.prod(s[1:] if k.startswith(STACKS) else s)
                    for k, s in param_shapes(cfg).items())
    for k, v in want.items():
        assert got[k].is_cuda and got[k].dtype == use_dtype(cfg, k), k
        assert torch.equal(got[k], v), k
    assert peak <= tree + piece + 2**20, (peak, tree, piece)
    assert tree + piece + 2**20 < 1.5 * tree


@pytest.mark.parametrize("arch", ["internvl2-26b", "seamless-m4t-large-v2"])
def test_zoo_train_step_on_card_equals_cpu(gen, arch):
    """fp32 with TF32 off: one ``lm`` train step of the reduced InternVL2
    (patches before the text) and SeamlessM4T (frames through the encoder,
    cross-attention) on the card against the CPU port on the same weights
    and batch: no kernel launched, the loss within 1e-5 relative, every
    gradient finite, non-zero and within 1e-3 of its leaf's largest
    element (6a's limits); AdamW's update finite."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.train import (OptimizerConfig, init_opt_state,
                                   loss_and_grads, make_loss_fn,
                                   make_train_step)
    cfg = get_config(arch, reduced=True).replace(dtype="float32")
    host = init_params(cfg, seed=6, device="cpu")
    g = torch.Generator().manual_seed(6)
    B, S = 2, 40
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    if cfg.frontend == "vision_patches":
        batch["patches"] = torch.randn((B, cfg.n_frontend_tokens,
                                        cfg.d_model), generator=g)
    else:
        batch["frames"] = torch.randn((B, 24, cfg.d_model), generator=g)
    card = {k: v.cuda() for k, v in host.items()}
    cbatch = {k: v.cuda() for k, v in batch.items()}
    loss_fn = make_loss_fn(cfg, "lm")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        n0 = dict(ops.launch_counts())
        g_card, m_card = loss_and_grads(loss_fn, card, cbatch)
        assert ops.launch_counts() == n0        # no kernel on the route
        new, state, _ = make_train_step(cfg, OptimizerConfig(), "lm")(
            card, init_opt_state(card), cbatch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    g_cpu, m_cpu = loss_and_grads(loss_fn, host, batch)
    torch.testing.assert_close(m_card["loss"].cpu(), m_cpu["loss"],
                               rtol=1e-5, atol=0)
    assert set(g_card) == set(g_cpu) == set(host)
    for k in g_cpu:
        got = g_card[k].cpu()
        scale = float(g_cpu[k].abs().max())
        assert bool(torch.isfinite(got).all()) and scale > 0, k
        assert float(got.abs().max()) > 0, k
        assert float((got - g_cpu[k]).abs().max()) <= 1e-3 * scale, k
    assert int(state["step"]) == 1
    assert all(bool(torch.isfinite(v).all()) for v in new.values())

def test_cohort_sweep_equals_oracle_on_card(gen):
    """bf16 on the card: a ``ScenarioEngine`` sweep through the paged,
    prefix-cached ``EngineBackend`` (background loop, 3 in flight) equals
    ``assert_sweep_parity``'s straight-line oracle bit for bit."""
    from repro_torch.api.client import EngineBackend
    from repro_torch.cohort import ScenarioEngine, assert_sweep_parity
    params, cfg = _delphi_bf16()
    pats = []
    for i in range(5):
        rng = np.random.default_rng(100 + i)
        toks = np.concatenate([[3], rng.integers(13, 90, 6)])
        ages = np.concatenate([[0.0], np.sort(rng.uniform(1.0, 40.0, 6))])
        pats.append((toks.astype(np.int32), ages.astype(np.float32)))
    be = EngineBackend.create(params, cfg, slots=4, max_context=64,
                              cache="paged", block_size=16, blocks=64,
                              prefix_cache=True, device="cuda")
    res = ScenarioEngine(be, max_in_flight=3, seed=11).sweep(
        pats, n_futures=3, max_new=8, horizon=20.0)
    assert res.n_failed == 0 and res.events_total > 0
    stats = assert_sweep_parity(res, params, cfg, pats, seed=11,
                                n_futures=3, max_new=8, horizon=20.0,
                                slots=4, max_context=64, device="cuda")
    assert stats["patients_checked"] == 5
    assert stats["events_checked"] == res.events_total


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_artifact_on_card_equals_eager_through_the_kernels(gen, tmp_path,
                                                           dtype):
    """A reduced Delphi artifact (traced on the CPU) loaded on the card:
    the full graph == eager ``forward`` bit for bit through the flash
    operator, prefill + decode steps == ``LocalBackend.stream`` token for
    token through the paged operator (launch counts per call)."""
    from repro_torch.api import ArtifactBackend, GenerateRequest, LocalBackend
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params
    from repro_torch.sdk import export_model
    cfg = get_config("delphi-2m", reduced=True).replace(
        dtype=dtype, vocab_size=96, max_seq_len=48)
    params = init_params(cfg, seed=5, device="cuda")
    export_model(params, cfg, str(tmp_path))
    art = ArtifactBackend(str(tmp_path), device="cuda")
    toks, ages = [3, 10, 20, 41], [0.0, 15.0, 28.0, 33.5]
    t, a = art._pad_inputs(toks, ages)
    ops.reset_launch_counts()
    got = art.runtime.run(t, a)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    with torch.no_grad():
        want = forward(params, cfg, {"tokens": torch.from_numpy(t).cuda(),
                                     "ages": torch.from_numpy(a).cuda()})
    assert np.array_equal(got, want["logits"].cpu().numpy())
    u = np.random.default_rng(1).uniform(size=(6, 96)).astype(np.float32)
    req = GenerateRequest(tokens=toks, ages=ages, max_new=6, uniforms=u,
                          max_age=1e9)
    ops.reset_launch_counts()
    res = art.generate(req)
    counts = ops.launch_counts()
    assert counts["paged_decode_attention"] > 0 and counts["tte_sample"] == 0
    s = list(LocalBackend(params, cfg, device="cuda").stream(req))
    assert (res.tokens, res.ages) == ([e.token for e in s],
                                      [e.age for e in s])


def test_sharded_prefill_and_decode_on_a_1x1_mesh_equal_the_plain_route(
        gen, tmp_path):
    """A one-rank NCCL group (a ``FileStore`` in ``tmp_path``) and its 1 x 1
    ``DeviceMesh`` on the card: reduced TinyLlama in bf16, its parameters,
    batch and ring cache placed by ``distribute_tree``; a prefill of 4 x
    96 and 4 decode steps on the DTensors themselves equal the plain
    route's logits and rings bit for bit, through the flash kernel once a
    layer and the paged kernel once a layer a step, with no collective."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.collectives import CollectiveCounter
    from repro_torch.launch.mesh import describe
    from repro_torch.models import decode_step, forward, init_params_on_device
    from repro_torch.models.attention import LayerCache
    B, S, n = 4, 96, 4
    cfg = get_config("tinyllama-1.1b", reduced=True)
    params = init_params_on_device(cfg, seed=0, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (B, S + n), generator=gen,
                         device="cuda", dtype=torch.int32)
    batch = {"tokens": toks[:, :S]}

    def clone(cache):
        return {k: LayerCache(*(t.clone() for t in v))
                for k, v in cache.items()}

    def decode(p, cache):
        return [decode_step(p, cfg, cache,
                            {"tokens": toks[:, S + i:S + i + 1]},
                            torch.full((B,), S + i, dtype=torch.int32,
                                       device="cuda"))["logits"]
                for i in range(n)]

    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, device_id=torch.device("cuda", 0))
    try:
        dm = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        mesh = describe(dm)
        with torch.no_grad():
            ref_out = forward(params, cfg, batch, mode="prefill",
                              cache_width=S + n)
            ring0 = clone(ref_out["cache"])
            ref_steps = decode(params, ref_out["cache"])
            dp = sh.distribute_tree(params, sh.param_shardings(mesh, params),
                                    dm)
            db = sh.distribute_tree(batch, sh.batch_shardings(mesh, batch),
                                    dm)
            ring = sh.distribute_tree(clone(ring0),
                                      sh.cache_shardings(mesh, ring0), dm)
            ops.reset_launch_counts()
            with CollectiveCounter() as cc:
                out = forward(dp, cfg, db, mode="prefill", cache_width=S + n)
                steps = decode(dp, ring)
            counts = ops.launch_counts()
    finally:
        dist.destroy_process_group()
    assert counts["flash_attention"] == cfg.n_layers
    assert counts["paged_decode_attention"] == cfg.n_layers * n
    assert cc.total == 0
    assert torch.equal(out["logits"].to_local(), ref_out["logits"])
    for a, b in zip(out["cache"]["self"], ring0["self"]):
        assert torch.equal(a.to_local(), b)
    for a, b in zip(steps, ref_steps):
        assert torch.equal(a.to_local(), b)
    for a, b in zip(ring["self"], ref_out["cache"]["self"]):
        assert torch.equal(a.to_local(), b)
