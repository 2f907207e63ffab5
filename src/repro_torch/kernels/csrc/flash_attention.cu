// Causal / sliding-window / bidirectional GQA attention with an online
// softmax in fp32 (prefill attention of the serving path).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:86
// (flash_attention, body _flash_kernel).  The Pallas grid walked key blocks
// sequentially, carrying (acc, m, l) in VMEM across grid steps; here one
// block owns one (batch, query head, 64-row query tile) and loops over key
// tiles itself.  Each thread owns one query row: the row, its fp32
// accumulator and its running (m, l) live in registers, while the key
// and value tile (BK rows) is staged once in shared memory and read by all
// 64 threads as broadcasts.  Key tiles wholly above the causal diagonal or
// below the sliding window are never loaded; the ragged S and T edges are
// masked in the kernel, so the wrapper pads nothing.  GQA reads key head
// h / G; the scale is hd^-0.5 of the true head width.  Inputs are fp32 or
// bf16 (a runtime code: one compiled kernel per head-width class serves
// both), converted to fp32 as the tile is staged.
//
// Bound on the card: at Delphi-2M's prefill shapes (hd = 10, S <= 256) the
// work is tiny and the call is latency- and instruction-bound; the head width is
// neither a multiple of 8 nor of 16, so this first kernel uses scalar fp32
// FMAs (head width padded to HDP in registers) rather than tensor cores.
// Making it tensor-core bound (mma/wgmma tiles over a zero-padded head) is
// later work.
#include <cmath>

#include "common.cuh"

constexpr int FA_BQ = 64;  // query rows (= threads) per block

struct Strides {
  long long b, h, s;  // element strides of the batch, head and row axes; unit stride inside a row
};

template <int HDP, int BK>
__global__ void __launch_bounds__(FA_BQ)
    flash_attention_kernel(const void* __restrict__ q, const void* __restrict__ k,
                           const void* __restrict__ v, void* __restrict__ o, int dtype,
                           Strides sq, Strides sk, Strides sv, Strides so, int G, int S, int T,
                           int hd, float scale, int causal, int window) {
  __shared__ float k_s[BK][HDP];
  __shared__ float v_s[BK][HDP];
  const int q0 = blockIdx.x * FA_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / G;
  const int row = q0 + threadIdx.x;
  const bool row_ok = row < S;

  float qr[HDP];
  float acc[HDP];
  const long long qoff = b * sq.b + h * sq.h + (long long)row * sq.s;
#pragma unroll
  for (int d = 0; d < HDP; ++d) {
    qr[d] = (row_ok && d < hd) ? load_f32(q, qoff + d, dtype) : 0.f;
    acc[d] = 0.f;
  }

  // key range this query tile can see; whole tiles outside it are skipped
  int k_begin = 0;
  int k_end = T;
  if (causal) {
    k_end = min(T, q0 + FA_BQ);
    if (window > 0) k_begin = max(0, q0 - window + 1);
  }
  k_begin = (k_begin / BK) * BK;

  const long long kb = b * sk.b + hk * sk.h;
  const long long vb = b * sv.b + hk * sv.h;
  float m = -INFINITY;
  float l = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int idx = threadIdx.x; idx < BK * HDP; idx += FA_BQ) {
      const int j = idx / HDP;
      const int d = idx % HDP;
      const int kj = k0 + j;
      const bool ok = kj < T && d < hd;
      k_s[j][d] = ok ? load_f32(k, kb + (long long)kj * sk.s + d, dtype) : 0.f;
      v_s[j][d] = ok ? load_f32(v, vb + (long long)kj * sv.s + d, dtype) : 0.f;
    }
    __syncthreads();

    float s[BK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int kj = k0 + j;
      bool valid = kj < T;
      if (causal) {
        const int rel = row - kj;
        valid = valid && rel >= 0 && (window <= 0 || rel < window);
      }
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HDP; ++d) dot = fmaf(qr[d], k_s[j][d], dot);
      s[j] = valid ? dot * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new != -INFINITY) {  // else nothing valid seen yet: state unchanged
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int d = 0; d < HDP; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float p = expf(s[j] - m_new);
        psum += p;
#pragma unroll
        for (int d = 0; d < HDP; ++d) acc[d] = fmaf(p, v_s[j][d], acc[d]);
      }
      l = l * alpha + psum;
      m = m_new;
    }
    __syncthreads();
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    const long long ooff = b * so.b + h * so.h + (long long)row * so.s;
#pragma unroll
    for (int d = 0; d < HDP; ++d)
      if (d < hd) store_f32(o, ooff + d, acc[d] / denom, dtype);
  }
}

template <int HDP, int BK>
static int launch_flash(int dtype, const void* q, const void* k, const void* v, void* o,
                        const Strides* st, int B, int Hq, int G, int S, int T, int hd,
                        float scale, int causal, int window, cudaStream_t stream) {
  const dim3 grid((S + FA_BQ - 1) / FA_BQ, Hq, B);
  flash_attention_kernel<HDP, BK><<<grid, FA_BQ, 0, stream>>>(
      q, k, v, o, dtype, st[0], st[1], st[2], st[3], G, S, T, hd, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// q: (B, Hq, S, hd), k/v: (B, Hkv, T, hd), o: (B, Hq, S, hd), all of one
// dtype (REPRO_F32 or REPRO_BF16), any batch/head/row strides with unit
// stride along hd.  strides: 12 element strides (b, h, s) of q, k, v, o.
// window <= 0 means no sliding window.  Returns cudaGetLastError().
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                      void* o, const long long* strides, int B, int Hq,
                                      int Hkv, int S, int T, int hd, float scale, int causal,
                                      int window, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (dtype != REPRO_F32 && dtype != REPRO_BF16) return static_cast<int>(cudaErrorInvalidValue);
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int G = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 16)
    return launch_flash<16, 32>(dtype, q, k, v, o, st, B, Hq, G, S, T, hd, scale, causal,
                                window, s);
  if (hd <= 32)
    return launch_flash<32, 32>(dtype, q, k, v, o, st, B, Hq, G, S, T, hd, scale, causal,
                                window, s);
  if (hd <= 64)
    return launch_flash<64, 16>(dtype, q, k, v, o, st, B, Hq, G, S, T, hd, scale, causal,
                                window, s);
  if (hd <= 128)
    return launch_flash<128, 8>(dtype, q, k, v, o, st, B, Hq, G, S, T, hd, scale, causal,
                                window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
