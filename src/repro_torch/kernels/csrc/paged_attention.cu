// One-token decode attention over a paged KV pool (and over the ring cache,
// which is the pool with one block per slot).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:82
// (paged_decode_attention, body _paged_kernel).  There the block table was
// scalar-prefetched and a sequential grid axis DMA'd one pool block per step
// into VMEM, carrying (acc, m, l).  Here one block owns one (slot, kv head)
// and walks the slot's logical ring w = 0 .. nbs*bs-1 in sub-tiles of 128
// tokens, one token per thread: the thread resolves its token through the
// table (entry -1: skipped, the pool is not read), applies the mask
// pos >= 0 & pos <= step & pos > step - W (& pos > step - window), and scores
// it against all G query heads of the group, so the G heads share every K
// row read.  Per sub-tile each warp folds one head's scores into the fp32
// online softmax (tile max, rescale, exponentials, sum); then the G*hd
// output elements are spread over the 128 threads, each summing p * v over a
// strided share of the tile's tokens, and one shared-memory pass combines
// the shares.  A slot with no valid token returns zeros (l clamped at
// 1e-30), like the TPU kernel.  Walking logical positions rather than whole
// blocks serves block sizes from 4 to 256 with the same full sub-tiles.
// q and the pools are fp32 or bf16 (a runtime code: one compiled kernel per
// head-width class serves both), read as fp32.
//
// Bound on the card: bytes.  Each valid token's K and V rows are read once
// (2 * hd elements) for 2 * G * hd FLOPs, far below the card's balance
// point; at Delphi-2M's ring (bs = W = 256, G = 1, hd = 10, 16 slots) one
// layer's call moves about 1 MB, so per-launch latency dominates.  The
// design keeps every read coalesced along the token axis and never
// materialises the gathered ring.
#include <cmath>

#include "common.cuh"

constexpr int PD_TT = 128;  // tokens per sub-tile = threads per block

template <int HDP>
__global__ void __launch_bounds__(PD_TT)
    paged_decode_kernel(const void* __restrict__ q, const void* __restrict__ k_pool,
                        const void* __restrict__ v_pool, const int* __restrict__ table,
                        const int* __restrict__ pos, const int* __restrict__ step,
                        void* __restrict__ out, int dtype, int Hkv, int G, int hd, int bs,
                        int nbs, int window, float scale) {
  extern __shared__ long long smem_ll[];
  long long* row_s = smem_ll;                      // [PD_TT] element offset of each token's row, -1 = masked
  float* q_s = reinterpret_cast<float*>(row_s + PD_TT);  // [G*HDP]
  float* acc_s = q_s + G * HDP;                    // [G*HDP]
  float* p_s = acc_s + G * HDP;                    // [G*PD_TT] scores, then probabilities
  float* red_s = p_s + G * PD_TT;                  // [PD_TT]
  float* m_s = red_s + PD_TT;                      // [G]
  float* l_s = m_s + G;                            // [G]
  float* a_s = l_s + G;                            // [G] this sub-tile's rescale factor

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int W = nbs * bs;
  const int stp = step[b];

  const long long qb = ((long long)b * Hkv + h) * G * hd;
  for (int i = tid; i < G * HDP; i += PD_TT) {
    const int g = i / HDP;
    const int d = i % HDP;
    q_s[i] = d < hd ? load_f32(q, qb + g * hd + d, dtype) : 0.f;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += PD_TT) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int P = G * hd;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = PD_TT >> 5;
  for (int w0 = 0; w0 < W; w0 += PD_TT) {
    // scores: one token per thread, all G heads
    const int w = w0 + tid;
    bool valid = false;
    long long row = 0;
    if (w < W) {
      const int blk = table[(long long)b * nbs + w / bs];
      if (blk >= 0) {
        const int off = w % bs;
        const int p = pos[(long long)blk * bs + off];
        valid = p >= 0 && p <= stp && p > stp - W && (window <= 0 || p > stp - window);
        row = (((long long)blk * Hkv + h) * bs + off) * hd;
      }
    }
    row_s[tid] = valid ? row : -1;
    float kr[HDP];
#pragma unroll
    for (int d = 0; d < HDP; ++d) kr[d] = (valid && d < hd) ? load_f32(k_pool, row + d, dtype) : 0.f;
    for (int g = 0; g < G; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HDP; ++d) dot = fmaf(q_s[g * HDP + d], kr[d], dot);
      p_s[g * PD_TT + tid] = valid ? dot * scale : -INFINITY;
    }
    __syncthreads();

    // online softmax over the sub-tile: one warp per query head
    for (int g = warp; g < G; g += nwarps) {
      float* sg = p_s + g * PD_TT;
      float mx = -INFINITY;
      for (int j = lane; j < PD_TT; j += 32) mx = fmaxf(mx, sg[j]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float alpha = 1.f;
      float sum = 0.f;
      if (m_new == -INFINITY) {
        for (int j = lane; j < PD_TT; j += 32) sg[j] = 0.f;
      } else {
        alpha = expf(m_old - m_new);
        for (int j = lane; j < PD_TT; j += 32) {
          const float pj = expf(sg[j] - m_new);
          sg[j] = pj;
          sum += pj;
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + sum;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // p . v: output elements spread over the threads, R shares each
    for (int pb = 0; pb < P; pb += PD_TT) {
      const int Pc = min(PD_TT, P - pb);
      const int R = PD_TT / Pc;
      float part = 0.f;
      if (tid < R * Pc) {
        const int pair = pb + tid % Pc;
        const int r = tid / Pc;
        const int g = pair / hd;
        const int d = pair % hd;
        const float* pg = p_s + g * PD_TT;
        for (int j = r; j < PD_TT; j += R) {
          const long long rw = row_s[j];
          if (rw >= 0) part = fmaf(pg[j], load_f32(v_pool, rw + d, dtype), part);
        }
      }
      red_s[tid] = part;
      __syncthreads();
      if (tid < Pc) {
        const int pair = pb + tid;
        const int g = pair / hd;
        const int d = pair % hd;
        float tot = 0.f;
        for (int r = 0; r < R; ++r) tot += red_s[r * Pc + tid];
        acc_s[g * HDP + d] = acc_s[g * HDP + d] * a_s[g] + tot;
      }
      __syncthreads();
    }
  }

  const long long ob = ((long long)b * Hkv + h) * G * hd;
  for (int i = tid; i < P; i += PD_TT) {
    const int g = i / hd;
    const int d = i % hd;
    store_f32(out, ob + i, acc_s[g * HDP + d] / fmaxf(l_s[g], 1e-30f), dtype);
  }
}

static size_t paged_smem_bytes(int G, int HDP) {
  return PD_TT * sizeof(long long) + sizeof(float) * (2 * G * HDP + G * PD_TT + PD_TT + 3 * G);
}

template <int HDP>
static int launch_paged(int dtype, const void* q, const void* k, const void* v,
                        const void* table, const void* pos, const void* step, void* out, int B,
                        int Hkv, int G, int hd, int bs, int nbs, int window, float scale,
                        cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  paged_decode_kernel<HDP><<<grid, PD_TT, paged_smem_bytes(G, HDP), stream>>>(
      q, k, v, static_cast<const int*>(table), static_cast<const int*>(pos),
      static_cast<const int*>(step), out, dtype, Hkv, G, hd, bs, nbs, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory the launch below asks for (the wrapper refuses a
// call above the 48 KB default limit).
extern "C" long long paged_decode_smem_bytes(int G, int hd) {
  const int HDP = hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : 128;
  return static_cast<long long>(paged_smem_bytes(G, HDP));
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
  if (hd <= 16)
    return launch_paged<16>(dtype, q, k_pool, v_pool, table, pos, step, out, B, Hkv, G, hd,
                            bs, nbs, window, scale, s);
  if (hd <= 32)
    return launch_paged<32>(dtype, q, k_pool, v_pool, table, pos, step, out, B, Hkv, G, hd,
                            bs, nbs, window, scale, s);
  if (hd <= 64)
    return launch_paged<64>(dtype, q, k_pool, v_pool, table, pos, step, out, B, Hkv, G, hd,
                            bs, nbs, window, scale, s);
  if (hd <= 128)
    return launch_paged<128>(dtype, q, k_pool, v_pool, table, pos, step, out, B, Hkv, G, hd,
                             bs, nbs, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
