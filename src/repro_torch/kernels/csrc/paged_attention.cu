// One-token decode attention over a paged KV pool (and over the ring cache,
// which is the pool with one block per slot).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:82
// (paged_decode_attention, body _paged_kernel).  There the block table was
// scalar-prefetched and a sequential grid axis DMA'd one pool block per step
// into VMEM, carrying (acc, m, l).  What it computes is kept: slot b's query
// heads attend the positions pos with pos >= 0 & pos <= step & pos > step - W
// (& pos > step - window), W = nbs * bs, through its table (entry -1: the
// block is skipped, the pool is not read), with an fp32 online softmax; the
// G query heads of a kv head share every K/V row read; a slot with nothing
// valid gives zeros (l clamped at 1e-30).
//
// Bound on the card: bytes, and far below them the latency of dependent
// loads.  At Delphi-2M's ring (bs = W = 256, G = 1, hd = 10, 16 slots, bf16)
// a layer's call needs about 0.3 MB (the valid tokens' K/V rows), 0.09 us at
// 3.35 TB/s, so what a call costs is its launch and its chain of memory
// round trips.  The design keeps that chain at three loads deep and spends
// nothing in series per token:
//  - One block of 4 warps per (slot, kv head, chunk of GC query heads).  A
//    lane group (1 lane at hd <= 16; 4, 8 or 16 lanes of 8 dims each for
//    wider heads) owns a strided share of the W logical positions, 2 per
//    pass, and a pass covers 256 positions at hd <= 16: the whole ring in
//    one pass at the main shape.
//  - A lane reads step and its tokens' table entries, then their positions,
//    then the K and V rows of its valid tokens together (V does not wait on
//    the softmax; masked tokens are never read), as 4-byte words where hd is
//    even.  Scores, the lane's running (m, l) and its p.v sums stay in
//    registers (an online softmax per lane).
//  - The lanes of a warp merge (m, l, acc) by shuffles, the sums by a
//    reduce-scatter whose levels each issue all their shuffles together (a
//    branch per dimension would make each dimension's chain of five wait on
//    the one before), the warps once through shared memory: one
//    __syncthreads in all.
// q and the pools are fp32 or bf16 (a template per type), summed in fp32.
#include <cmath>

#include "common.cuh"

constexpr int PD_THREADS = 128;
constexpr int PD_WARPS = PD_THREADS / 32;
constexpr int PD_TPL = 2;  // tokens per lane group per pass

// the DPL dims [d0, d0 + DPL) of one row as fp32: the first nd from memory
// (element offset off), the rest zero; bf16 rows are read in 4-byte words
// where ``words`` says that hd is even and the tensors 4-byte aligned
template <bool BF16, int DPL>
__device__ __forceinline__ void load_dims(float (&x)[DPL], const void* base, long long off, int nd,
                                          bool words) {
  if constexpr (BF16) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(base) + off;
    if (words) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
      for (int i = 0; i < DPL / 2; ++i) {
        const uint32_t u = 2 * i < nd ? __ldg(w + i) : 0u;
        x[2 * i] = __uint_as_float(u << 16);
        x[2 * i + 1] = __uint_as_float(u & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int d = 0; d < DPL; ++d) x[d] = d < nd ? __bfloat162float(p[d]) : 0.f;
    }
  } else {
    const float* p = static_cast<const float*>(base) + off;
#pragma unroll
    for (int d = 0; d < DPL; ++d) x[d] = d < nd ? __ldg(p + d) : 0.f;
  }
}

__host__ __device__ constexpr int ilog2(int n) { return n > 1 ? 1 + ilog2(n / 2) : 0; }

// Sums x[0, N) over the lanes of a warp that differ in the lane bits O, O/2,
// ..., LPT, halving what a lane holds at each level while it holds more than
// one value: at offset o a lane keeps the lower or upper half (by its bit o)
// and receives its partner's share of that half, so a level costs N/2
// shuffles, not N.  On return x[0, N >> halvings) hold the sums of dims
// [base, base + N >> halvings) of x as it came in; returns base.
template <int N, int O, int LPT>
__device__ __forceinline__ int reduce_scatter(float* x, int lane) {
  if constexpr (O < LPT) {
    return 0;
  } else if constexpr (N > 1) {
    constexpr int H = N / 2;
    const bool upper = lane & O;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = upper ? x[i] : x[i + H];
      const float keep = upper ? x[i + H] : x[i];
      x[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    return (upper ? H : 0) + reduce_scatter<H, O / 2, LPT>(x, lane);
  } else {
    x[0] += __shfl_xor_sync(0xffffffffu, x[0], O);
    return reduce_scatter<1, O / 2, LPT>(x, lane);
  }
}

// DPL dims per lane, LPT lanes per token, GC query heads per block
template <bool BF16, int DPL, int LPT, int GC>
__global__ void __launch_bounds__(PD_THREADS)
    paged_decode_kernel(const void* __restrict__ q, const void* __restrict__ k_pool,
                        const void* __restrict__ v_pool, const int* __restrict__ table,
                        const int* __restrict__ pos, const int* __restrict__ step,
                        void* __restrict__ out, int Hkv, int G, int hd, int bs, int nbs,
                        int window, float scale, int words) {
  constexpr int HD = DPL * LPT;
  constexpr int GROUPS = PD_THREADS / LPT;  // lane groups = tokens at a time
  constexpr int TOK = GROUPS * PD_TPL;      // positions per pass
  __shared__ float m_s[PD_WARPS][GC];
  __shared__ float l_s[PD_WARPS][GC];
  __shared__ float acc_s[PD_WARPS][GC][HD];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g0 = blockIdx.z * GC;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = tid / LPT;
  const int d0 = (tid % LPT) * DPL;
  const int nd = max(0, min(DPL, hd - d0));
  const int W = nbs * bs;
  const int stp = __ldg(step + b);
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units: p = 2^(s - m)

  float qr[GC][DPL];
  const long long qb = (((long long)b * Hkv + h) * G + g0) * hd + d0;
#pragma unroll
  for (int g = 0; g < GC; ++g) load_dims<BF16, DPL>(qr[g], q, qb + (long long)g * hd, nd, words);

  float m[GC], l[GC], acc[GC][DPL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[g][d] = 0.f;
  }

  for (int w0 = 0; w0 < W; w0 += TOK) {
    // table entries, then positions, then K and V of the valid tokens
    int blk[PD_TPL], off[PD_TPL];
#pragma unroll
    for (int t = 0; t < PD_TPL; ++t) {
      const int w = w0 + t * GROUPS + grp;
      const int jb = nbs == 1 ? 0 : w / bs;  // one block per slot: the ring
      off[t] = w - jb * bs;
      blk[t] = w < W ? __ldg(table + (long long)b * nbs + jb) : -1;
    }
    bool ok[PD_TPL];
#pragma unroll
    for (int t = 0; t < PD_TPL; ++t) {
      const int p = blk[t] >= 0 ? __ldg(pos + (long long)blk[t] * bs + off[t]) : -1;
      ok[t] = p >= 0 && p <= stp && p > stp - W && (window <= 0 || p > stp - window);
    }
    float kr[PD_TPL][DPL], vr[PD_TPL][DPL];
#pragma unroll
    for (int t = 0; t < PD_TPL; ++t) {
      const long long row = (((long long)blk[t] * Hkv + h) * bs + off[t]) * hd + d0;
      const int n = ok[t] ? nd : 0;  // masked tokens are never read
      load_dims<BF16, DPL>(kr[t], k_pool, row, n, words);
      load_dims<BF16, DPL>(vr[t], v_pool, row, n, words);
    }

#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float s[PD_TPL];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < PD_TPL; ++t) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DPL; ++d) dot = fmaf(qr[g][d], kr[t][d], dot);
#pragma unroll
        for (int o = LPT / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[t] = ok[t] ? dot * sl2 : -INFINITY;
        mx = fmaxf(mx, s[t]);
      }
      const float m_new = fmaxf(m[g], mx);
      if (m_new != -INFINITY) {  // else nothing valid yet: state unchanged
        const float alpha = fast_exp2(m[g] - m_new);
        l[g] *= alpha;
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[g][d] *= alpha;
#pragma unroll
        for (int t = 0; t < PD_TPL; ++t) {
          const float p = fast_exp2(s[t] - m_new);
          l[g] += p;
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[g][d] = fmaf(p, vr[t][d], acc[g][d]);
        }
        m[g] = m_new;
      }
    }
  }

  // merge the lane groups of a warp: rescale to the warp's max, then sum by
  // a reduce-scatter (at hd <= 16: 16 shuffles for the 16 dims, not 80)
  constexpr int LEVELS = ilog2(32 / LPT);               // offsets 16 .. LPT
  constexpr int HALVINGS = LEVELS < ilog2(DPL) ? LEVELS : ilog2(DPL);
  constexpr int NF = DPL >> HALVINGS;                   // dims a lane ends with
  constexpr int DUP = HALVINGS < LEVELS ? ((16 >> HALVINGS) << 1) - LPT : 0;  // same-sum lanes
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    float mw = m[g];
#pragma unroll
    for (int o = 16; o >= LPT; o >>= 1) mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, o));
    const float f = m[g] == -INFINITY ? 0.f : fast_exp2(m[g] - mw);
    l[g] *= f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[g][d] *= f;
#pragma unroll
    for (int o = 16; o >= LPT; o >>= 1) l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
    const int base = d0 + reduce_scatter<DPL, 16, LPT>(acc[g], lane);
    if ((lane & DUP) == 0) {
#pragma unroll
      for (int i = 0; i < NF; ++i)
        if (base + i < hd) acc_s[warp][g][base + i] = acc[g][i];
    }
    if (lane == 0) {
      m_s[warp][g] = mw;
      l_s[warp][g] = l[g];
    }
  }
  __syncthreads();

  // merge the warps: one output element per thread
  const long long ob = (((long long)b * Hkv + h) * G + g0) * hd;
  for (int i = tid; i < GC * hd; i += PD_THREADS) {
    const int g = i / hd;
    const int d = i % hd;
    float mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < PD_WARPS; ++w) mb = fmaxf(mb, m_s[w][g]);
    float num = 0.f, den = 0.f;
    if (mb != -INFINITY) {
#pragma unroll
      for (int w = 0; w < PD_WARPS; ++w) {
        const float f = m_s[w][g] == -INFINITY ? 0.f : fast_exp2(m_s[w][g] - mb);
        num = fmaf(acc_s[w][g][d], f, num);
        den = fmaf(l_s[w][g], f, den);
      }
    }
    store_f32(out, ob + i, num * __frcp_rn(fmaxf(den, 1e-30f)), BF16 ? REPRO_BF16 : REPRO_F32);
  }
}

template <bool BF16, int DPL, int LPT, int GC>
static void launch_gc(dim3 grid, cudaStream_t stream, const void* q, const void* k,
                      const void* v, const int* table, const int* pos, const int* step, void* out,
                      int Hkv, int G, int hd, int bs, int nbs, int window, float scale, int words) {
  static_assert(sizeof(float) * PD_WARPS * GC * (DPL * LPT + 2) <= 48 * 1024,
                "static shared memory above 48 KB");
  paged_decode_kernel<BF16, DPL, LPT, GC><<<grid, PD_THREADS, 0, stream>>>(
      q, k, v, table, pos, step, out, Hkv, G, hd, bs, nbs, window, scale, words);
}

// the query heads of a kv head go to blocks of GC = the largest of 8, 4, 2,
// 1 that divides G, each block reading the K/V rows once for its GC heads
template <bool BF16, int DPL, int LPT>
static int launch_paged(const void* q, const void* k, const void* v, const int* table,
                        const int* pos, const int* step, void* out, int B, int Hkv, int G, int hd,
                        int bs, int nbs, int window, float scale, int words, cudaStream_t s) {
  const int gc = G % 8 == 0 ? 8 : G % 4 == 0 ? 4 : G % 2 == 0 ? 2 : 1;
  const dim3 grid(Hkv, B, G / gc);
  if (gc == 8)
    launch_gc<BF16, DPL, LPT, 8>(grid, s, q, k, v, table, pos, step, out, Hkv, G, hd, bs, nbs,
                                 window, scale, words);
  else if (gc == 4)
    launch_gc<BF16, DPL, LPT, 4>(grid, s, q, k, v, table, pos, step, out, Hkv, G, hd, bs, nbs,
                                 window, scale, words);
  else if (gc == 2)
    launch_gc<BF16, DPL, LPT, 2>(grid, s, q, k, v, table, pos, step, out, Hkv, G, hd, bs, nbs,
                                 window, scale, words);
  else
    launch_gc<BF16, DPL, LPT, 1>(grid, s, q, k, v, table, pos, step, out, Hkv, G, hd, bs, nbs,
                                 window, scale, words);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16>
static int launch_paged_hd(const void* q, const void* k, const void* v, const int* table,
                           const int* pos, const int* step, void* out, int B, int Hkv, int G,
                           int hd, int bs, int nbs, int window, float scale, int words,
                           cudaStream_t s) {
  if (hd <= 16)
    return launch_paged<BF16, 16, 1>(q, k, v, table, pos, step, out, B, Hkv, G, hd, bs, nbs,
                                     window, scale, words, s);
  if (hd <= 32)
    return launch_paged<BF16, 8, 4>(q, k, v, table, pos, step, out, B, Hkv, G, hd, bs, nbs,
                                    window, scale, words, s);
  if (hd <= 64)
    return launch_paged<BF16, 8, 8>(q, k, v, table, pos, step, out, B, Hkv, G, hd, bs, nbs,
                                    window, scale, words, s);
  if (hd <= 128)
    return launch_paged<BF16, 8, 16>(q, k, v, table, pos, step, out, B, Hkv, G, hd, bs, nbs,
                                     window, scale, words, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q: (B, Hkv, G, hd); k/v pool: (NB, Hkv, bs, hd); out: (B, Hkv, G, hd), all
// contiguous and of one dtype (REPRO_F32 or REPRO_BF16); table (B, nbs),
// pos (NB, bs) and step (B,) contiguous int32.  window <= 0 means none.
// Returns cudaGetLastError().
extern "C" int paged_decode_launch(int dtype, const void* q, const void* k_pool,
                                   const void* v_pool, const void* table, const void* pos,
                                   const void* step, void* out, int B, int Hkv, int G, int hd,
                                   int bs, int nbs, int window, float scale, void* stream) {
  if (B == 0) return 0;
  if (dtype != REPRO_F32 && dtype != REPRO_BF16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* ps = static_cast<const int*>(pos);
  const int* st = static_cast<const int*>(step);
  // bf16 rows as 4-byte words: even hd and 4-byte aligned q and pools
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k_pool) |
                         reinterpret_cast<uintptr_t>(v_pool);
  const int words = hd % 2 == 0 && addr % 4 == 0;
  if (dtype == REPRO_BF16)
    return launch_paged_hd<true>(q, k_pool, v_pool, tb, ps, st, out, B, Hkv, G, hd, bs, nbs,
                                 window, scale, words, s);
  return launch_paged_hd<false>(q, k_pool, v_pool, tb, ps, st, out, B, Hkv, G, hd, bs, nbs,
                                window, scale, words, s);
}
