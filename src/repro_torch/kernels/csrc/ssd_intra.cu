// Mamba2 SSD intra-chunk term and chunk states, in fp32:
//
//     y_diag = (C B^T o L) xdt,    L_ij = exp(cum_i - cum_j) for i >= j, else 0
//     state  = B^T (exp(cum_last - cum) o xdt)
//
// for every (batch row, head, chunk) tile: xdt (Q, P), B and C (Q, N), cum (Q).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:50 (ssd_intra, body
// _ssd_intra_kernel).  The Pallas grid walked (batch*head, chunk) tiles in
// order with the whole tile in VMEM and three MXU products.  Here one block of
// 16 x 16 threads owns one tile; the tile is staged in shared memory as fp32
// and the three products run as register-tiled fp32 FMAs on the CUDA cores
// (no TF32: the model's SSD is fp32, and the tests hold it to 1e-4).  Each
// thread owns a strided micro-tile (rows ty + 16a, columns tx + 16b), so in
// every product the 16 lanes of a half-warp read 16 consecutive words of one
// operand and at most two distinct words of the other; the row strides of
// C, B and G are padded to an odd length so column reads do not conflict.
//
// Layout: the launcher takes batch, chunk and head as separate axes with
// their own element strides (unit stride inside a row), so the model passes
// xdt in its (b, c, Q, H, P) layout, B and C once per batch row with a head
// stride of 0 (n_groups = 1: all heads share them), and y is written in
// (b, c, Q, H, P), where the model adds the inter-chunk term.  Inputs are
// fp32 or bf16 (runtime codes, one for xdt and one for B/C); cum, y and the
// states are fp32.
//
// exp(cum_i - cum_j) is taken only for j <= i: above the diagonal the exponent
// is positive and can overflow, and inf * 0 would be NaN.
//
// Bound on the card: operations.  A tile needs Q(Q+1)N + Q(Q+1)P + 2QNP flops
// (only the causal triangle of C B^T and of G xdt; 5.3 MFLOP at Q 128, P 64,
// N 128) against ~100 kB of its own traffic (xdt in, y and the state out;
// B and C are shared by the 48 heads), so at fp32 CUDA-core rates
// (67 TFLOP/s on the H100 SXM) the products, not the bytes, set the time.
// The design keeps every product in registers (8 x 8 and 8 x 4 accumulators
// a thread) fed from shared memory; the production tile needs 162 kB of
// shared memory, so one block runs per SM and the kernel opts in to dynamic
// shared memory above 48 kB.  Steps 1 and 2 still run the full Q x Q square
// (8.4 MFLOP a tile, ~37% of it on entries the mask zeroes); skipping the
// sub-tiles above the diagonal and tensor-core products (wgmma, TMA
// staging) are later work.
#include <cmath>

#include "common.cuh"

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
    ssd_intra_kernel(const void* __restrict__ xdt, const void* __restrict__ Bm,
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
static int launch_ssd(int dt_x, int dt_bc, const void* xdt, const void* Bm, const void* Cm,
                      const float* cum, float* y, float* st, const SsdStrides* s, int batch,
                      int heads, int chunks, int P, int N, cudaStream_t stream) {
  const int smem = ssd_smem_floats(QT * SSD_TD, P, N) * static_cast<int>(sizeof(float));
  if (smem > SSD_MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  // once per instantiation: allow up to the per-block limit, so every later
  // launch skips the attribute call
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      ssd_intra_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SSD_MAX_SMEM);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid(chunks, heads, batch);
  ssd_intra_kernel<QT><<<grid, SSD_THREADS, smem, stream>>>(
      xdt, Bm, Cm, cum, y, st, dt_x, dt_bc, s[0], s[1], s[2], s[3], s[4], s[5], P, N);
  return static_cast<int>(cudaGetLastError());
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
  switch (Q) {
    case 16:
      return launch_ssd<1>(dt_x, dt_bc, xdt, Bm, Cm, cu, yo, so, s, batch, heads, chunks, P, N, str);
    case 32:
      return launch_ssd<2>(dt_x, dt_bc, xdt, Bm, Cm, cu, yo, so, s, batch, heads, chunks, P, N, str);
    case 64:
      return launch_ssd<4>(dt_x, dt_bc, xdt, Bm, Cm, cu, yo, so, s, batch, heads, chunks, P, N, str);
    case 128:
      return launch_ssd<8>(dt_x, dt_bc, xdt, Bm, Cm, cu, yo, so, s, batch, heads, chunks, P, N, str);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
