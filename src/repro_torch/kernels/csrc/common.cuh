// Shared helpers of the port's CUDA kernels: element loads and stores of
// fp32 or bf16 tensors (the dtype is a runtime code, uniform over a launch,
// so each kernel is compiled once for both types), the dtype codes the
// Python wrappers pass, 2^x on the SFU, and the cp.async, ldmatrix and
// mma.sync wrappers of the tensor-core kernels.
#pragma once

#include <cstdint>

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

// 2^x by the SFU (ex2.approx.ftz: about 2 ulp, results below 2^-126 flushed
// to 0, and 2^-inf = 0), without exp2f's rescaling of tiny results: the
// softmax weights of the attention kernels
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// N = 4, 8 or 16 bytes to the shared-memory address dst (smem_addr), each
// address aligned to N
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src), "n"(N));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for all of this thread's cp.async copies
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// four 8 x 8 bf16 matrices; lane l gives the row address of row l % 8 of
// matrix l / 8 and receives (row l / 4, columns 2(l % 4), +1) of each
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, transposed: lane l receives (rows 2(l % 4), +1, column l / 4)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 as one register: lo in the low half (the lower k index)
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}
