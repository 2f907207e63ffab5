// Mamba2 SSD intra-chunk term and chunk states, in fp32:
//
//     y_diag = (C B^T o L) xdt,    L_ij = exp(cum_i - cum_j) for i >= j, else 0
//     state  = B^T (exp(cum_last - cum) o xdt)
//
// for every (batch row, head, chunk) tile: xdt (Q, P), B and C (Q, N), cum (Q).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:50 (ssd_intra, body
// _ssd_intra_kernel).  The Pallas grid walked (batch*head, chunk) tiles in
// order with the whole tile in VMEM and three MXU products.
//
// Bound on the card: bytes.  At the model's main shape (a 1024-token prompt:
// 8 chunks x 48 heads of Q 128, P 64, N 128; fp32 xdt, bf16 B and C shared by
// the heads through a head stride of 0) a call must move 38.5 MB (xdt in, y
// and the states out, B, C and cum once), 11.5 us at 3.35 TB/s, and needs
// 1.23 GFLOP: C B^T once per chunk (the heads share it), C B^T o L and its
// product with xdt over the causal triangle only, the state product in full.
// With fp32-accurate products on the tensor cores (three TF32 passes, 165
// TFLOP/s) that is 7.4 us; on the fp32 CUDA cores it would be 18.3 us, so
// the products must leave the CUDA cores for the bytes to set the time.
//
// Design (bf16 B and C, the model's case): tensor-core products by mma.sync,
// split so that each keeps fp32 accuracy (held to 1e-4 against the fp32
// plain version), and only the work on or under the diagonal.
//  - One block of 8 warps per tile stages it in shared memory by cp.async:
//    B and C in bf16, xdt in fp32 (103 kB at the main shape, so two blocks
//    share an SM and one block's staging overlaps the other's products).
//    The second half of B's and xdt's rows lands behind an mbarrier that a
//    warp waits on only when it reaches those rows.  Warps 0-3 write y,
//    warps 4-7 the state.  Where even two blocks per tile would leave SMs
//    idle (a one-chunk prompt: 48 tiles), a tile takes two blocks, one for
//    y and one for the state, each with 8 warps and less to do per warp.
//  - y: like flash attention, a warp owns rows: the 16-row blocks r and
//    QT - 1 - r, so every warp has the same share of the causal triangle.
//    For each 16-column block on or under the diagonal it forms its strip
//    of C B^T in one bf16 pass (bf16 products are exact in fp32), applies L
//    in registers (exp only for j <= i: above the diagonal the exponent is
//    positive and can overflow, and inf * 0 would be NaN), and multiplies by
//    xdt in three TF32 passes (G_lo x_hi + G_hi x_lo + G_hi x_hi; one pass
//    misses 1e-4).  G never goes to shared memory, and blocks above the
//    diagonal are never formed.  C B^T is formed per head: sharing it across
//    the heads would put them in one block and cost the grid its width.
//  - state: a warp owns 16 (8 in the split layout) columns of P and all of
//    N; B^T comes from shared memory by ldmatrix.trans (exact in bf16), and
//    dec o xdt is split into three bf16 pieces, one pass each (two pieces
//    leave too little margin to 1e-4).
//  - What holds it back (PERF.md): mma.sync's issue rate and latency with
//    16 warps an SM, and the tail of the last wave of tiles.
// fp32 B or C (the JAX signature's cases) take the fp32 CUDA-core kernel
// below instead: one block of 16 x 16 threads per tile, the tile in fp32
// shared memory, register-tiled FMAs.
//
// Layout: the launcher takes batch, chunk and head as separate axes with
// their own element strides (unit stride inside a row), so the model passes
// xdt in its (b, c, Q, H, P) layout, B and C once per batch row with a head
// stride of 0 (n_groups = 1: all heads share them), and y is written in
// (b, c, Q, H, P), where the model adds the inter-chunk term.  Inputs are
// fp32 or bf16 (runtime codes, one for xdt and one for B/C); cum, y and the
// states are fp32.
#include <cmath>
#include <cstdint>

#include "common.cuh"

// ---------------------------------------------------------------------------
// fp32 CUDA-core route: fp32 B and C.
// ---------------------------------------------------------------------------
constexpr int SSD_TD = 16;                       // the block is SSD_TD x SSD_TD threads
constexpr int SSD_THREADS = SSD_TD * SSD_TD;
constexpr int SSD_PT = 4;                        // y, state: columns p = tx + 16b, b < 4
constexpr int SSD_NT = 8;                        // state: rows n = ty + 16a, a < 8
constexpr int SSD_MAX_P = SSD_PT * SSD_TD;       // 64
constexpr int SSD_MAX_N = SSD_NT * SSD_TD;       // 128
constexpr int SSD_MAX_SMEM = 232448;             // per-block limit on sm_90

struct SsdStrides {
  long long b, c, h, r;  // element strides of the batch, chunk, head and row axes
};

static inline int ssd_smem_floats(int Q, int P, int N) {
  const int cs = N + 1, gs = Q + 1;
  return Q * (cs > gs ? cs : gs) + Q * cs + Q * P + 2 * Q;
}

template <int QT>
__global__ void __launch_bounds__(SSD_THREADS)
    ssd_intra_simt_kernel(const void* __restrict__ xdt, const void* __restrict__ Bm,
                     const void* __restrict__ Cm, const float* __restrict__ cum,
                     float* __restrict__ y, float* __restrict__ st, int dt_x, int dt_bc,
                     SsdStrides sx, SsdStrides sb, SsdStrides sc, SsdStrides su,
                     SsdStrides sy, SsdStrides ss, int P, int N) {
  constexpr int Q = QT * SSD_TD;
  extern __shared__ float smem[];
  const int cs = N + 1;  // odd row strides: a column read by 16 lanes
  const int gs = Q + 1;  // touches 16 different banks
  float* sCG = smem;                           // C (Q x cs), then G (Q x gs)
  float* sB = sCG + Q * (cs > gs ? cs : gs);   // B (Q x cs)
  float* sX = sB + Q * cs;                     // xdt (Q x P)
  float* sCum = sX + Q * P;                    // cum (Q)
  float* sDec = sCum + Q;                      // exp(cum_last - cum) (Q)

  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % SSD_TD;
  const int ty = tid / SSD_TD;

  const long long xo = b * sx.b + c * sx.c + h * sx.h;
  const long long bo = b * sb.b + c * sb.c + h * sb.h;
  const long long co = b * sc.b + c * sc.c + h * sc.h;
  const long long uo = b * su.b + c * su.c + h * su.h;
  for (int e = tid; e < Q * N; e += SSD_THREADS) {
    const int q = e / N;
    const int n = e - q * N;
    sB[q * cs + n] = load_f32(Bm, bo + q * sb.r + n, dt_bc);
    sCG[q * cs + n] = load_f32(Cm, co + q * sc.r + n, dt_bc);
  }
  for (int e = tid; e < Q * P; e += SSD_THREADS) {
    const int q = e / P;
    const int p = e - q * P;
    sX[q * P + p] = load_f32(xdt, xo + q * sx.r + p, dt_x);
  }
  for (int q = tid; q < Q; q += SSD_THREADS) sCum[q] = cum[uo + q * su.r];
  __syncthreads();
  for (int q = tid; q < Q; q += SSD_THREADS) sDec[q] = expf(sCum[Q - 1] - sCum[q]);

  // 1. G = (C B^T) o L, summed over n
  float g[QT][QT];
#pragma unroll
  for (int a = 0; a < QT; ++a)
#pragma unroll
    for (int j = 0; j < QT; ++j) g[a][j] = 0.f;
  for (int n = 0; n < N; ++n) {
    float av[QT], bv[QT];
#pragma unroll
    for (int a = 0; a < QT; ++a) av[a] = sCG[(ty + SSD_TD * a) * cs + n];
#pragma unroll
    for (int j = 0; j < QT; ++j) bv[j] = sB[(tx + SSD_TD * j) * cs + n];
#pragma unroll
    for (int a = 0; a < QT; ++a)
#pragma unroll
      for (int j = 0; j < QT; ++j) g[a][j] = fmaf(av[a], bv[j], g[a][j]);
  }
  __syncthreads();  // every thread is done with C (and sDec is written): G replaces C
#pragma unroll
  for (int a = 0; a < QT; ++a) {
    const int i = ty + SSD_TD * a;
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      const int jj = tx + SSD_TD * j;
      sCG[i * gs + jj] = jj <= i ? g[a][j] * expf(sCum[i] - sCum[jj]) : 0.f;
    }
  }
  __syncthreads();

  // 2. y = G xdt, summed over j (G is 0 above the diagonal)
  {
    float acc[QT][SSD_PT];
#pragma unroll
    for (int a = 0; a < QT; ++a)
#pragma unroll
      for (int t = 0; t < SSD_PT; ++t) acc[a][t] = 0.f;
    for (int j = 0; j < Q; ++j) {
      float gv[QT], xv[SSD_PT];
#pragma unroll
      for (int a = 0; a < QT; ++a) gv[a] = sCG[(ty + SSD_TD * a) * gs + j];
#pragma unroll
      for (int t = 0; t < SSD_PT; ++t) {
        const int p = tx + SSD_TD * t;
        xv[t] = p < P ? sX[j * P + p] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < QT; ++a)
#pragma unroll
        for (int t = 0; t < SSD_PT; ++t) acc[a][t] = fmaf(gv[a], xv[t], acc[a][t]);
    }
    const long long yo = b * sy.b + c * sy.c + h * sy.h;
#pragma unroll
    for (int a = 0; a < QT; ++a) {
      const int i = ty + SSD_TD * a;
#pragma unroll
      for (int t = 0; t < SSD_PT; ++t) {
        const int p = tx + SSD_TD * t;
        if (p < P) y[yo + i * sy.r + p] = acc[a][t];
      }
    }
  }

  // 3. state = B^T (decay o xdt), summed over j
  {
    float acc[SSD_NT][SSD_PT];
#pragma unroll
    for (int a = 0; a < SSD_NT; ++a)
#pragma unroll
      for (int t = 0; t < SSD_PT; ++t) acc[a][t] = 0.f;
    for (int j = 0; j < Q; ++j) {
      const float d = sDec[j];
      float bv[SSD_NT], xv[SSD_PT];
#pragma unroll
      for (int a = 0; a < SSD_NT; ++a) {
        const int n = ty + SSD_TD * a;
        bv[a] = n < N ? sB[j * cs + n] : 0.f;
      }
#pragma unroll
      for (int t = 0; t < SSD_PT; ++t) {
        const int p = tx + SSD_TD * t;
        xv[t] = p < P ? d * sX[j * P + p] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < SSD_NT; ++a)
#pragma unroll
        for (int t = 0; t < SSD_PT; ++t) acc[a][t] = fmaf(bv[a], xv[t], acc[a][t]);
    }
    const long long so = b * ss.b + c * ss.c + h * ss.h;
#pragma unroll
    for (int a = 0; a < SSD_NT; ++a) {
      const int n = ty + SSD_TD * a;
#pragma unroll
      for (int t = 0; t < SSD_PT; ++t) {
        const int p = tx + SSD_TD * t;
        if (n < N && p < P) st[so + n * ss.r + p] = acc[a][t];
      }
    }
  }
}

template <int QT>
static int launch_ssd_simt(int dt_x, int dt_bc, const void* xdt, const void* Bm, const void* Cm,
                      const float* cum, float* y, float* st, const SsdStrides* s, int batch,
                      int heads, int chunks, int P, int N, cudaStream_t stream) {
  const int smem = ssd_smem_floats(QT * SSD_TD, P, N) * static_cast<int>(sizeof(float));
  if (smem > SSD_MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  // once per instantiation: allow up to the per-block limit, so every later
  // launch skips the attribute call
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      ssd_intra_simt_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SSD_MAX_SMEM);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid(chunks, heads, batch);
  ssd_intra_simt_kernel<QT><<<grid, SSD_THREADS, smem, stream>>>(
      xdt, Bm, Cm, cum, y, st, dt_x, dt_bc, s[0], s[1], s[2], s[3], s[4], s[5], P, N);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Tensor-core route: bf16 B and C (the model's case), fp32 or bf16 xdt.
// ---------------------------------------------------------------------------
constexpr int MMA_WARPS = 8;
constexpr int MMA_THREADS = MMA_WARPS * 32;
// B, C and xdt are staged padded with zeros to N = 128 and P = 64, so every
// loop bound below is a constant and the products are straight-line code
constexpr int MMA_CS = SSD_MAX_N + 8;  // bf16 row stride of B and C
constexpr int MMA_XS = SSD_MAX_P + 4;  // fp32 row stride of xdt
constexpr int MMA_NK = SSD_MAX_N / 16;  // 16-wide steps over N

// wait for all but the most recent committed group of this thread's copies
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// the barrier's arrival of this thread, once its earlier cp.async copies land
__device__ __forceinline__ void mbar_arrive_after_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// wait until the barrier completes its first phase
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared.b64 done, [%0], 0;\n"
      "@!done bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// d += a b: a 16 x 8 tf32 (row), b 8 x 8 tf32 (col), d 16 x 8 fp32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 (10 mantissa bits), half away from zero, as
// cvt.rna.tf32.f32 rounds finite values, in two integer operations
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to ~22 bits: hi is x rounded to TF32, lo the rest rounded
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// x = p0 + p1 + p2 in bf16 to fp32's 24 bits
__device__ __forceinline__ void split_bf16x3(float x, __nv_bfloat16 (&p)[3]) {
  p[0] = __float2bfloat16_rn(x);
  const float r1 = x - __bfloat162float(p[0]);
  p[1] = __float2bfloat16_rn(r1);
  p[2] = __float2bfloat16_rn(r1 - __bfloat162float(p[1]));
}

// 8 bf16 of a row of B or C into shared memory; zeros past the row's end
__device__ __forceinline__ void stage_bf16x8(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                             int left, int vec) {
  if (vec && left >= 8) {
    cp_async16(dst, src);
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u) dst[u] = u < left ? src[u] : __float2bfloat16_rn(0.f);
  }
}

// 4 elements of a row of xdt into shared memory as fp32; zeros past its end
__device__ __forceinline__ void stage_x4(float* dst, const void* base, long long i, int left,
                                         int dt, int vec) {
  if (vec && left >= 4) {
    cp_async16(dst, static_cast<const float*>(base) + i);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[u] = u < left ? load_f32(base, i + u, dt) : 0.f;
  }
}

// y rows of one warp: row blocks r0 and r1 = QT - 1 - r0 (16 rows each, so
// every warp owns 9 of the 36 causal 16 x 16 blocks at Q 128), P columns
// [8 n8_0, 8 n8_0 + 8 NQ).  Per 16-column block jb <= r of row block r:
// S = C B^T in one bf16 pass (bf16 products are exact in fp32), G = S o L in
// registers, then y += G xdt in three TF32 passes (G_lo x_hi + G_hi x_lo +
// G_hi x_hi).  The accumulator of S holds (row g, columns 2t, 2t+1) and
// (row g + 8, ...); a TF32 A fragment wants (row g, columns t, t + 4), so
// the k index of the second product is permuted (slot t = column 2t, slot
// t + 4 = column 2t + 1) and xdt's rows are read in the same order.  The
// instructions issue in the order written, so loads come ahead of the
// products that use them and no product waits on the one just before it.
template <int QT, int NQ>
__device__ __forceinline__ void ssd_y_rows(const __nv_bfloat16* sB, const __nv_bfloat16* sC,
                                           const float* sX, const float* sCum, int half,
                                           uint64_t* late, int r0, int n8_0,
                                           float* __restrict__ y, long long yo, long long syr,
                                           int P) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  if (2 * r0 > QT - 1) return;
  const int r1 = QT - 1 - r0;
  // ldmatrix row addresses: A fragments (C rows) and B fragments (B rows)
  const int a_off = (lane & 15) * MMA_CS + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * MMA_CS + ((lane >> 3) & 1) * 8;
  for (int rb = 0; rb < 2; ++rb) {
    const int r = rb == 0 ? r0 : r1;
    if (rb == 1 && r1 == r0) break;
    const __nv_bfloat16* cRow = sC + 16 * r * MMA_CS + a_off;
    const int i0 = 16 * r + g;
    const float ci0 = sCum[i0];
    const float ci1 = sCum[i0 + 8];
    float acc[NQ][4];
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
    for (int jb = 0; jb <= r; ++jb) {
      if (jb == half) mbar_wait(late);  // rows of B and xdt from 16 half on
      // S for columns [16jb, 16jb + 8) (s[0]) and [16jb + 8, 16jb + 16)
      // (s[1]), k split over two accumulators each; the fragments of step
      // k + 1 load while step k multiplies
      const __nv_bfloat16* bRow = sB + 16 * jb * MMA_CS + b_off;
      float s[2][2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[a][u][e] = 0.f;
      uint32_t fa[2][4], fb[2][4];
      ldmatrix_x4(fa[0], cRow);
      ldmatrix_x4(fb[0], bRow);
#pragma unroll
      for (int k = 0; k < MMA_NK; ++k) {
        if (k + 1 < MMA_NK) {
          ldmatrix_x4(fa[(k + 1) & 1], cRow + 16 * (k + 1));
          ldmatrix_x4(fb[(k + 1) & 1], bRow + 16 * (k + 1));
        }
        mma_bf16(s[0][k & 1], fa[k & 1], fb[k & 1][0], fb[k & 1][1]);
        mma_bf16(s[1][k & 1], fa[k & 1], fb[k & 1][2], fb[k & 1][3]);
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int j = 16 * jb + 8 * nb + 2 * t;
        const float cj0 = sCum[j];
        const float cj1 = sCum[j + 1];
        // L only where j <= i: above the diagonal the exponent is positive
        // (and could overflow), so exp is taken of 0 there and the entry
        // selected away
        const bool m0 = j <= i0, m1 = j + 1 <= i0, m2 = j <= i0 + 8, m3 = j + 1 <= i0 + 8;
        const float e0 = expf(m0 ? ci0 - cj0 : 0.f);
        const float e1 = expf(m1 ? ci0 - cj1 : 0.f);
        const float e2 = expf(m2 ? ci1 - cj0 : 0.f);
        const float e3 = expf(m3 ? ci1 - cj1 : 0.f);
        const float v0 = m0 ? (s[nb][0][0] + s[nb][1][0]) * e0 : 0.f;
        const float v1 = m1 ? (s[nb][0][1] + s[nb][1][1]) * e1 : 0.f;
        const float v2 = m2 ? (s[nb][0][2] + s[nb][1][2]) * e2 : 0.f;
        const float v3 = m3 ? (s[nb][0][3] + s[nb][1][3]) * e3 : 0.f;
        uint32_t gh[4], gl[4];  // slots (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
        split_tf32(v0, gh[0], gl[0]);
        split_tf32(v2, gh[1], gl[1]);
        split_tf32(v1, gh[2], gl[2]);
        split_tf32(v3, gh[3], gl[3]);
        // xdt rows j, j + 1 in groups of four 8-column blocks; the three
        // passes, each over the group's four blocks in turn
        const float* x0 = sX + j * MMA_XS + 8 * n8_0 + g;
#pragma unroll
        for (int q0 = 0; q0 < NQ; q0 += 4) {
          uint32_t xh[4][2], xl[4][2];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            split_tf32(x0[8 * (q0 + q)], xh[q][0], xl[q][0]);
            split_tf32(x0[MMA_XS + 8 * (q0 + q)], xh[q][1], xl[q][1]);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) mma_tf32(acc[q0 + q], gl, xh[q][0], xh[q][1]);
#pragma unroll
          for (int q = 0; q < 4; ++q) mma_tf32(acc[q0 + q], gh, xl[q][0], xl[q][1]);
#pragma unroll
          for (int q = 0; q < 4; ++q) mma_tf32(acc[q0 + q], gh, xh[q][0], xh[q][1]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int p = 8 * (n8_0 + q) + 2 * t;
      float* y0 = y + yo + i0 * syr + p;
      float* y1 = y0 + 8 * syr;
      if (p < P) {
        y0[0] = acc[q][0];
        y1[0] = acc[q][2];
      }
      if (p + 1 < P) {
        y0[1] = acc[q][1];
        y1[1] = acc[q][3];
      }
    }
  }
}

// state columns [8 n8_0, 8 n8_0 + 8 NC) of one warp, all N rows: state =
// B^T (dec o xdt) with B^T as A fragments (ldmatrix.trans of B, exact in
// bf16) and dec o xdt split into three bf16 pieces, one pass each (small
// pieces first, every pass over all of the warp's accumulators in turn).
template <int QT, int NC>
__device__ __forceinline__ void ssd_state_cols(const __nv_bfloat16* sB, const float* sX,
                                               const float* sCum, int half, uint64_t* late,
                                               int n8_0,
                                               float* __restrict__ st, long long so,
                                               long long ssr, int P, int N) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float clast = sCum[16 * QT - 1];
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * MMA_CS + ((lane >> 3) & 1) * 8;
  float acc[MMA_NK][NC][4];
#pragma unroll
  for (int m = 0; m < MMA_NK; ++m)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][c][e] = 0.f;
#pragma unroll
  for (int k = 0; k < QT; ++k) {
    if (k == half) mbar_wait(late);  // rows of B and xdt from 16 half on
    uint32_t a[MMA_NK][4];
    const __nv_bfloat16* bRow = sB + 16 * k * MMA_CS + b_off;
#pragma unroll
    for (int m = 0; m < MMA_NK; ++m) ldmatrix_x4_trans(a[m], bRow + 16 * m);
    // B-fragment rows (k index j): 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1)
    const int js[4] = {16 * k + 2 * t, 16 * k + 2 * t + 1, 16 * k + 2 * t + 8,
                       16 * k + 2 * t + 9};
    float dec[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) dec[u] = expf(clast - sCum[js[u]]);
    uint32_t b0[NC][3], b1[NC][3];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      __nv_bfloat16 d[4][3];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        split_bf16x3(dec[u] * sX[js[u] * MMA_XS + 8 * (n8_0 + c) + g], d[u]);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        b0[c][q] = pack_bf16(d[0][q], d[1][q]);
        b1[c][q] = pack_bf16(d[2][q], d[3][q]);
      }
    }
#pragma unroll
    for (int q = 2; q >= 0; --q)
#pragma unroll
      for (int m = 0; m < MMA_NK; ++m)
#pragma unroll
        for (int c = 0; c < NC; ++c) mma_bf16(acc[m][c], a[m], b0[c][q], b1[c][q]);
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int p = 8 * (n8_0 + c) + 2 * t;
#pragma unroll
    for (int m = 0; m < MMA_NK; ++m) {
      const int n = 16 * m + g;
      float* s0 = st + so + n * ssr + p;
      float* s1 = s0 + 8 * ssr;
      if (n < N && p < P) s0[0] = acc[m][c][0];
      if (n < N && p + 1 < P) s0[1] = acc[m][c][1];
      if (n + 8 < N && p < P) s1[0] = acc[m][c][2];
      if (n + 8 < N && p + 1 < P) s1[1] = acc[m][c][3];
    }
  }
}

// One block of 8 warps per (batch row, head, chunk) tile: warps 0-3 write y
// (warp w the row blocks w and QT - 1 - w, all of P), warps 4-7 the state
// (16 columns of P each).  With SPLIT a tile takes two blocks, blockIdx.x =
// 2 chunk + role: role 0 writes y (warp w the row blocks w % 4 and
// QT - 1 - w % 4, P columns [32 (w / 4), +32)), role 1 the state (8 columns
// a warp).
// Shared memory: B and C as bf16 rows of 136 (N padded to 128; the 16 extra
// bytes put the 8 rows of an ldmatrix on 8 different bank groups), xdt as
// fp32 rows of 68 (P padded to 64; the 4 extra words keep the B-fragment
// reads conflict-free), cum.  Staged by cp.async where the rows are 16-byte
// aligned.
template <int QT, bool SPLIT>
__global__ void __launch_bounds__(MMA_THREADS, 2)
    ssd_intra_mma_kernel(const void* __restrict__ xdt, const __nv_bfloat16* __restrict__ Bm,
                         const __nv_bfloat16* __restrict__ Cm, const float* __restrict__ cum,
                         float* __restrict__ y, float* __restrict__ st, int dt_x, int vec_x,
                         int vec_bc, SsdStrides sx, SsdStrides sb, SsdStrides sc,
                         SsdStrides su, SsdStrides sy, SsdStrides ss, int P, int N) {
  constexpr int Q = 16 * QT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sC = sB + Q * MMA_CS;
  float* sX = reinterpret_cast<float*>(sC + Q * MMA_CS);
  float* sCum = sX + Q * MMA_XS;

  // role 0: y, 1: the state, 2: both
  const int role = SPLIT ? blockIdx.x & 1 : 2;
  const int c = SPLIT ? blockIdx.x >> 1 : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const long long xo = b * sx.b + c * sx.c + h * sx.h;
  const long long bo = b * sb.b + c * sb.c + h * sb.h;
  const long long co = b * sc.b + c * sc.c + h * sc.h;
  const long long uo = b * su.b + c * su.c + h * su.h;

  // Two stages: C, cum and the first `half` 16-row blocks of B and xdt,
  // waited for by the whole block; then the rest of B and xdt, which a warp
  // waits for (on `late`) only when it reaches row block `half`, so these
  // copies overlap the products over the first rows.  Where cp.async
  // cannot copy every element of the second stage (unaligned rows, bf16
  // xdt, zero padding) everything is staged in the first.
  __shared__ uint64_t late;
  if (tid == 0) mbar_init(&late, MMA_THREADS);
  __syncthreads();
  const int half = vec_x && vec_bc && N == SSD_MAX_N && P == SSD_MAX_P ? QT / 2 : QT;
  for (int e = tid; e < Q * (SSD_MAX_N / 8); e += MMA_THREADS) {
    const int q = e / (SSD_MAX_N / 8);
    const int n = (e % (SSD_MAX_N / 8)) * 8;
    if (q < 16 * half) stage_bf16x8(sB + q * MMA_CS + n, Bm + bo + q * sb.r + n, N - n, vec_bc);
    if (role != 1) stage_bf16x8(sC + q * MMA_CS + n, Cm + co + q * sc.r + n, N - n, vec_bc);
  }
  for (int e = tid; e < 16 * half * (SSD_MAX_P / 4); e += MMA_THREADS) {
    const int q = e / (SSD_MAX_P / 4);
    const int p = (e % (SSD_MAX_P / 4)) * 4;
    stage_x4(sX + q * MMA_XS + p, xdt, xo + q * sx.r + p, P - p, dt_x, vec_x);
  }
  for (int q = tid; q < Q; q += MMA_THREADS) sCum[q] = cum[uo + q * su.r];
  cp_async_commit();
  for (int e = tid + 16 * half * (SSD_MAX_N / 8); e < Q * (SSD_MAX_N / 8); e += MMA_THREADS) {
    const int q = e / (SSD_MAX_N / 8);
    const int n = (e % (SSD_MAX_N / 8)) * 8;
    stage_bf16x8(sB + q * MMA_CS + n, Bm + bo + q * sb.r + n, N - n, vec_bc);
  }
  for (int e = tid + 16 * half * (SSD_MAX_P / 4); e < Q * (SSD_MAX_P / 4); e += MMA_THREADS) {
    const int q = e / (SSD_MAX_P / 4);
    const int p = (e % (SSD_MAX_P / 4)) * 4;
    stage_x4(sX + q * MMA_XS + p, xdt, xo + q * sx.r + p, P - p, dt_x, vec_x);
  }
  mbar_arrive_after_copies(&late);
  cp_async_commit();
  cp_async_wait_prior();
  __syncthreads();

  const int warp = tid >> 5;
  const long long yo = b * sy.b + c * sy.c + h * sy.h;
  const long long so = b * ss.b + c * ss.c + h * ss.h;
  if (role == 0)
    ssd_y_rows<QT, 4>(sB, sC, sX, sCum, half, &late, warp & 3, (warp >> 2) * 4, y, yo, sy.r, P);
  else if (role == 1)
    ssd_state_cols<QT, 1>(sB, sX, sCum, half, &late, warp, st, so, ss.r, P, N);
  else if (warp < 4)
    ssd_y_rows<QT, 8>(sB, sC, sX, sCum, half, &late, warp, 0, y, yo, sy.r, P);
  else
    ssd_state_cols<QT, 2>(sB, sX, sCum, half, &late, 2 * (warp - 4), st, so, ss.r, P, N);
}

static inline int ssd_mma_smem_bytes(int Q) {
  return 2 * Q * MMA_CS * 2 + Q * MMA_XS * 4 + Q * 4;
}

// streaming multiprocessors of the current device (read once)
static int sm_count() {
  static const int n = [] {
    int dev = 0, v = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

template <int QT, bool SPLIT>
static int launch_ssd_mma_as(int dt_x, int vec_x, int vec_bc, const void* xdt, const void* Bm,
                             const void* Cm, const float* cum, float* y, float* st,
                             const SsdStrides* s, int batch, int heads, int chunks, int P,
                             int N, cudaStream_t stream) {
  // once per instantiation: dynamic shared memory above 48 kB, and the
  // largest shared-memory carveout, so two blocks fit on an SM
  static const cudaError_t opt_in = [] {
    cudaError_t e = cudaFuncSetAttribute(ssd_intra_mma_kernel<QT, SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         ssd_mma_smem_bytes(16 * QT));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_intra_mma_kernel<QT, SPLIT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid(SPLIT ? 2 * chunks : chunks, heads, batch);
  ssd_intra_mma_kernel<QT, SPLIT><<<grid, MMA_THREADS, ssd_mma_smem_bytes(16 * QT), stream>>>(
      xdt, static_cast<const __nv_bfloat16*>(Bm), static_cast<const __nv_bfloat16*>(Cm), cum,
      y, st, dt_x, vec_x, vec_bc, s[0], s[1], s[2], s[3], s[4], s[5], P, N);
  return static_cast<int>(cudaGetLastError());
}

// one block per tile, or two where that still leaves at most one block per SM
template <int QT>
static int launch_ssd_mma(int dt_x, int vec_x, int vec_bc, const void* xdt, const void* Bm,
                          const void* Cm, const float* cum, float* y, float* st,
                          const SsdStrides* s, int batch, int heads, int chunks, int P, int N,
                          cudaStream_t stream) {
  if (2LL * batch * heads * chunks <= sm_count())
    return launch_ssd_mma_as<QT, true>(dt_x, vec_x, vec_bc, xdt, Bm, Cm, cum, y, st, s, batch,
                                       heads, chunks, P, N, stream);
  return launch_ssd_mma_as<QT, false>(dt_x, vec_x, vec_bc, xdt, Bm, Cm, cum, y, st, s, batch,
                                      heads, chunks, P, N, stream);
}

// xdt (batch, chunks, Q, heads, P) in dt_x; Bm, Cm (batch, chunks, Q, heads, N)
// in dt_bc (a head stride of 0 shares one tile among heads); cum (batch,
// chunks, Q, heads) fp32; y (batch, chunks, Q, heads, P) fp32; st (batch,
// chunks, heads, N, P) fp32.  strides: 24 element strides, (b, c, h, row) of
// xdt, Bm, Cm, cum, y and st, in that order (row = the Q axis; for st the N
// axis); unit stride along P and N.  Q is 16, 32, 64 or 128; P <= 64,
// N <= 128.  Returns cudaGetLastError() after the launch.
extern "C" int ssd_intra_launch(int dt_x, int dt_bc, const void* xdt, const void* Bm,
                                const void* Cm, const void* cum, void* y, void* st,
                                const long long* strides, int batch, int heads, int chunks,
                                int Q, int P, int N, void* stream) {
  if (batch == 0 || heads == 0 || chunks == 0) return 0;
  if ((dt_x != REPRO_F32 && dt_x != REPRO_BF16) || (dt_bc != REPRO_F32 && dt_bc != REPRO_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (P < 1 || P > SSD_MAX_P || N < 1 || N > SSD_MAX_N)
    return static_cast<int>(cudaErrorInvalidValue);
  SsdStrides s[6];
  for (int i = 0; i < 6; ++i)
    s[i] = SsdStrides{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2], strides[4 * i + 3]};
  const float* cu = static_cast<const float*>(cum);
  float* yo = static_cast<float*>(y);
  float* so = static_cast<float*>(st);
  cudaStream_t str = static_cast<cudaStream_t>(stream);
  if (dt_bc == REPRO_BF16) {
    // cp.async takes 16-byte rows: aligned pointers and strides
    auto aligned = [](const void* p, const SsdStrides& t, int elems) {
      return reinterpret_cast<uintptr_t>(p) % 16 == 0 && t.b % elems == 0 &&
             t.c % elems == 0 && t.h % elems == 0 && t.r % elems == 0;
    };
    const int vec_x = dt_x == REPRO_F32 && aligned(xdt, s[0], 4);
    const int vec_bc = aligned(Bm, s[1], 8) && aligned(Cm, s[2], 8);
    switch (Q) {
      case 16:
        return launch_ssd_mma<1>(dt_x, vec_x, vec_bc, xdt, Bm, Cm, cu, yo, so, s, batch, heads,
                                 chunks, P, N, str);
      case 32:
        return launch_ssd_mma<2>(dt_x, vec_x, vec_bc, xdt, Bm, Cm, cu, yo, so, s, batch, heads,
                                 chunks, P, N, str);
      case 64:
        return launch_ssd_mma<4>(dt_x, vec_x, vec_bc, xdt, Bm, Cm, cu, yo, so, s, batch, heads,
                                 chunks, P, N, str);
      case 128:
        return launch_ssd_mma<8>(dt_x, vec_x, vec_bc, xdt, Bm, Cm, cu, yo, so, s, batch, heads,
                                 chunks, P, N, str);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (Q) {
    case 16:
      return launch_ssd_simt<1>(dt_x, dt_bc, xdt, Bm, Cm, cu, yo, so, s, batch, heads, chunks, P, N, str);
    case 32:
      return launch_ssd_simt<2>(dt_x, dt_bc, xdt, Bm, Cm, cu, yo, so, s, batch, heads, chunks, P, N, str);
    case 64:
      return launch_ssd_simt<4>(dt_x, dt_bc, xdt, Bm, Cm, cu, yo, so, s, batch, heads, chunks, P, N, str);
    case 128:
      return launch_ssd_simt<8>(dt_x, dt_bc, xdt, Bm, Cm, cu, yo, so, s, batch, heads, chunks, P, N, str);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
