// Eq.-1 competing-exponential sampler, fused:
//
//     t_i = -exp(-logit_i) * ln(clip(u_i, 1e-12, 1 - 1e-12))
//     event = argmin_i t_i (lowest index wins ties),  t_min = min_i t_i
//
// Replaces the TPU kernel src/repro/kernels/tte_sample.py:64 (tte_sample,
// body _tte_kernel).  There the vocabulary was tiled over a sequential grid
// axis carrying the running (min, argmin) in VMEM scratch; blocks run in no
// order on this card, so one block owns one row instead: its threads stride
// over V with a private (t, index) pair and then reduce by warp shuffles and
// one shared-memory pass.  The ragged end of V is masked in the loop, so no
// padded copy of the inputs is made.
//
// Bound on the card: bytes.  Each element is read once (logit + uniform,
// 8 bytes) for one exp, one log and a multiply; at Delphi's V = 1289 and 16
// slots the whole call moves 165 kB, so launch latency, not bandwidth, sets
// its time.  Accurate expf/logf (no fast-math) keep t within a few ulp of
// the plain PyTorch version, so events agree except at near-ties.
//
// fp32 note: 1 - 1e-12 rounds to 1.0f, as it does in the JAX code and the
// plain version; a uniform of exactly 1 therefore gives t = -0.
#include <climits>
#include <cmath>

#include "common.cuh"

// (t, i) beats (bt, bi): smaller time, or equal time at a lower index
__device__ __forceinline__ void tte_take(float t, int i, float& bt, int& bi) {
  if (t < bt || (t == bt && i < bi)) {
    bt = t;
    bi = i;
  }
}

__global__ void tte_sample_kernel(const float* __restrict__ logits,
                                  const float* __restrict__ u,
                                  long long stride_l, long long stride_u, int V,
                                  int* __restrict__ evt, float* __restrict__ tmin) {
  const int b = blockIdx.x;
  const float* lg = logits + (long long)b * stride_l;
  const float* ub = u + (long long)b * stride_u;
  const float lo = 1e-12f;
  const float hi = 1.0f - 1e-12f;
  float bt = INFINITY;
  int bi = INT_MAX;
  for (int i = threadIdx.x; i < V; i += blockDim.x) {
    const float uc = fminf(fmaxf(ub[i], lo), hi);
    const float t = -expf(-lg[i]) * logf(uc);
    tte_take(t, i, bt, bi);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(0xffffffffu, bt, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    tte_take(ot, oi, bt, bi);
  }
  __shared__ float s_t[32];
  __shared__ int s_i[32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    s_t[warp] = bt;
    s_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    bt = lane < nwarps ? s_t[lane] : INFINITY;
    bi = lane < nwarps ? s_i[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(0xffffffffu, bt, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      tte_take(ot, oi, bt, bi);
    }
    if (lane == 0) {
      evt[b] = bi;
      tmin[b] = bt;
    }
  }
}

// logits, u: (B, V) fp32 rows with unit element stride; evt (B,) int32,
// tmin (B,) fp32.  Returns cudaGetLastError() after the launch.
extern "C" int tte_sample_launch(const void* logits, const void* u, long long stride_l,
                                 long long stride_u, int B, int V, void* evt, void* tmin,
                                 void* stream) {
  if (B == 0) return 0;
  const int threads = V >= 8192 ? 1024 : 256;
  tte_sample_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(u), stride_l, stride_u, V,
      static_cast<int*>(evt), static_cast<float*>(tmin));
  return static_cast<int>(cudaGetLastError());
}
