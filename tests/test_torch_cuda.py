"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and ``nvcc`` (the kernels are built at first
use); without a card each one skips.  They import neither JAX nor the JAX
package, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances are those of ``tests/test_kernels.py``: fp32 atol 2e-5, bf16
atol 2e-2 against the plain version in fp32 on the same rounded inputs;
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


def _tol(dtype):
    return 2e-5 if dtype == torch.float32 else 2e-2


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
    torch.testing.assert_close(out.float(), want, atol=_tol(dtype), rtol=0)


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
                               atol=_tol(dtype), rtol=0)
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
    torch.testing.assert_close(out.float(), want, atol=_tol(dtype), rtol=0)


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
    torch.testing.assert_close(out.float(), want, atol=2e-2, rtol=0)


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
    torch.testing.assert_close(out.float(), want, atol=2e-2, rtol=0)
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
