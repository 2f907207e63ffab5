// Shared helpers of the port's CUDA kernels: element loads and stores of
// fp32 or bf16 tensors (the dtype is a runtime code, uniform over a launch,
// so each kernel is compiled once for both types), warp reductions and the
// dtype codes the Python wrappers pass.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes (repro_torch/kernels/build.py: DTYPE_CODES)
#define REPRO_F32 0
#define REPRO_BF16 1

// element i of an fp32 or bf16 array, as fp32
__device__ __forceinline__ float load_f32(const void* p, long long i, int dtype) {
  return dtype == REPRO_BF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                             : static_cast<const float*>(p)[i];
}

// store x as element i of an fp32 or bf16 array (round to nearest even)
__device__ __forceinline__ void store_f32(void* p, long long i, float x, int dtype) {
  if (dtype == REPRO_BF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(p)[i] = x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
