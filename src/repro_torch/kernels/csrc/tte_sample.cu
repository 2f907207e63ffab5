// Eq.-1 competing-exponential sampler, fused:
//
//     t_i = -exp(-logit_i) * ln(clip(u_i, 1e-12, 1 - 1e-12))
//     event = argmin_i t_i (lowest index wins ties),  t_min = min_i t_i
//
// Replaces the TPU kernel src/repro/kernels/tte_sample.py:64 (tte_sample,
// body _tte_kernel).  There the vocabulary was tiled over a sequential grid
// axis carrying the running (min, argmin) in VMEM scratch.  Blocks run in no
// order on this card, so a row is cut into contiguous parts, one per block of
// a thread-block cluster (1 to 8 blocks), and the parts meet in shared memory.
//
// Bound on the card: bytes.  Each element is read once (logit + uniform,
// 8 bytes) for one exp, one log and a multiply.  At Delphi's V = 1289 and 16
// slots the call moves 165 kB (0.049 us at 3.35 TB/s), far under the launch
// and one load round trip, so latency sets its time.  At a 256,206-token
// vocabulary and 16 rows it moves 32.8 MB (9.79 us); accurate expf + logf
// and the key take ~45 instructions an element, a third of them integer,
// compare or select, which on an H100 (700 W) takes ~14 us on 96 SMs even
// with the inputs in L2, so the rows must be spread over as many SMs as
// will hold them.  What the design does about it:
//
// - One packed key per candidate: ((bits(t) & 0x7fffffff) << 32) | i.  One
//   unsigned 64-bit min then gives the least t and, among equal t, the lowest
//   index, with no branch.  t is never negative except -0 (u = 1 clips to
//   1 - 1e-12, which is 1.0f, so ln u = 0); +0 comes from exp(-l) = 0.
//   Clearing the sign ranks -0 equal to +0, as jnp.argmin does, and the
//   lower index wins.  NaN (l < -88.7 with u = 1: -inf * 0) ranks above
//   +inf and never wins against a number, as in the first design.  t_min is
//   the winner's high word, so a -0 winner comes back as +0 (equal under ==).
// - One round of loads: each thread takes R 16-byte slots of logits and as
//   many of uniforms per round (R a template parameter picked from V), all
//   issued before the first expf.  At V = 1289 the whole row is one round.
//   Where a part takes more rounds, the next round's loads are issued before
//   this round's exp/log.  Rows start at b * stride * 4 bytes, so a row's
//   first 0-3 elements (the head, up to the first 16-byte boundary of the
//   logits) and its last 0-3 (the tail) are taken one by one, by threads 0-2
//   of rank 0 and 4-6 of the last rank, their loads issued before the first
//   round's.  Where logits and uniforms are not aligned alike, the same
//   slots are read as 4-byte words (the VEC = false instances).
// - Branch-free reductions: in a warp, redux.sync (__reduce_min_sync) on the
//   high word, then on the index among the lanes that hold that minimum; one
//   barrier; the same over the warps' keys.
// - A cluster per row for large V: each block reduces its part to one key
//   and stores it into rank 0's shared memory (distributed shared memory,
//   mapa + st.shared::cluster).  One cluster barrier (release/acquire) later,
//   rank 0 reduces the C keys and writes the row's result.  A relaxed arrive
//   at entry, waited on just before that store, makes sure every block of
//   the cluster has started before any writes into another's shared memory.
//   One launch, no global scratch, no atomics: the result does not depend on
//   the order in which blocks run.  C is picked from V and from how many
//   clusters the card holds at once (plan_for): a 1024-thread block of the
//   large-V instances takes an SM's registers, only 15 clusters of 7 or 8
//   such blocks fit in the H100's GPCs, so 16 rows take clusters of 6
//   (96 SMs) rather than two waves of 8.
//
// Accurate expf/logf (no fast-math) keep t bit-equal to the plain PyTorch
// version on the card (t_min error 0 in every check so far); the checks
// still allow events to differ at near-ties (t within 1e-6 relative).
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr unsigned long long kNoKey = ~0ull;  // loses to every real key
constexpr int kMaxCluster = 8;

__device__ __forceinline__ unsigned long long tte_key(float l, float uu, int i) {
  const float lo = 1e-12f;
  const float hi = 1.0f - 1e-12f;
  const float uc = fminf(fmaxf(uu, lo), hi);
  const float t = -expf(-l) * logf(uc);
  return (static_cast<unsigned long long>(__float_as_uint(t) & 0x7fffffffu) << 32) |
         static_cast<unsigned int>(i);
}

// the least key of the warp, in every lane: min of the high words, then min
// of the indices among the lanes holding that high word
__device__ __forceinline__ unsigned long long warp_min_key(unsigned long long k) {
  const unsigned int khi = static_cast<unsigned int>(k >> 32);
  const unsigned int mhi = __reduce_min_sync(0xffffffffu, khi);
  const unsigned int mlo =
      __reduce_min_sync(0xffffffffu, khi == mhi ? static_cast<unsigned int>(k) : 0xffffffffu);
  return (static_cast<unsigned long long>(mhi) << 32) | mlo;
}

// the least key of the block, in every thread (one barrier)
__device__ __forceinline__ unsigned long long block_min_key(unsigned long long k,
                                                            unsigned long long* s_warp) {
  k = warp_min_key(k);
  const int lane = threadIdx.x & 31;
  if (lane == 0) s_warp[threadIdx.x >> 5] = k;
  __syncthreads();
  return warp_min_key(lane < static_cast<int>(blockDim.x >> 5) ? s_warp[lane] : kNoKey);
}

__device__ __forceinline__ unsigned int cluster_rank() {
  unsigned int r;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned int cluster_id() {
  unsigned int r;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// *dst = v, dst a shared-memory variable of block `rank` of this cluster
__device__ __forceinline__ void store_to_rank(unsigned long long* dst, unsigned int rank,
                                              unsigned long long v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_addr(dst)), "r"(rank));
  asm volatile("st.shared::cluster.u64 [%0], %1;" ::"r"(remote), "l"(v) : "memory");
}

// Loads through the read-only path, as volatile asm: the compiler keeps
// them where they are written, ahead of the exp/log work that follows them,
// rather than sinking each next to its first use.  Each element is read
// once, so the loads stream (.cs: evict-first in L1 and L2) and do not push
// other kernels' lines out of the L2.
__device__ __forceinline__ float4 ld_nc_v4(const float* p) {
  float4 v;
  asm volatile("ld.global.cs.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ float ld_nc(const float* p) {
  float v;
  asm volatile("ld.global.cs.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// 16-byte slot q of a row (4 floats from element 4q), as one load where VEC
template <bool VEC>
__device__ __forceinline__ float4 load_slot(const float* row, int q) {
  if constexpr (VEC) {
    return ld_nc_v4(row + 4 * q);
  } else {
    const float* p = row + 4 * q;
    return make_float4(ld_nc(p), ld_nc(p + 1), ld_nc(p + 2), ld_nc(p + 3));
  }
}

// one round: slots q0 + k T (k < R) of logits and uniforms, each index
// clamped to q_last so that every load is unconditional and in bounds
template <int R, bool VEC>
__device__ __forceinline__ void load_round(const float* lb, const float* ub, int q0, int T,
                                           int q_last, float4 (&L)[R], float4 (&U)[R]) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int q = min(q0 + k * T, q_last);
    L[k] = load_slot<VEC>(lb, q);
    U[k] = load_slot<VEC>(ub, q);
  }
}

// the least key of one round's slots (those at or past q_hi masked);
// element 4q + c of the body is element h + 4q + c of the row
template <int R>
__device__ __forceinline__ unsigned long long round_min(const float4 (&L)[R],
                                                        const float4 (&U)[R], int h, int q0,
                                                        int T, int q_hi) {
  unsigned long long best = kNoKey;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int q = q0 + k * T;
    const int i = h + 4 * q;
    unsigned long long m = tte_key(L[k].x, U[k].x, i);
    m = min(m, tte_key(L[k].y, U[k].y, i + 1));
    m = min(m, tte_key(L[k].z, U[k].z, i + 2));
    m = min(m, tte_key(L[k].w, U[k].w, i + 3));
    best = min(best, q < q_hi ? m : kNoKey);
  }
  return best;
}

// One row per cluster of C blocks (CLUSTER = false: C = 1, no cluster launch).
// R: 16-byte slots a thread takes per round, of logits and of uniforms each.
// VEC: logits and uniforms are aligned alike, so the body is read by 16-byte
// loads from the first 16-byte boundary of each row's logits.
template <int R, bool VEC, bool CLUSTER>
__global__ void __launch_bounds__(1024)
    tte_sample_kernel(const float* __restrict__ logits, const float* __restrict__ u,
                      long long stride_l, long long stride_u, int V, int C,
                      int* __restrict__ evt, float* __restrict__ tmin) {
  __shared__ unsigned long long s_warp[32];
  __shared__ unsigned long long s_rank[kMaxCluster];
  if constexpr (CLUSTER) cluster_arrive_relaxed();
  if constexpr (!CLUSTER) C = 1;
  const int rank = CLUSTER ? static_cast<int>(cluster_rank()) : 0;
  const int b = CLUSTER ? static_cast<int>(cluster_id()) : static_cast<int>(blockIdx.x);
  const float* lg = logits + (long long)b * stride_l;
  const float* ub = u + (long long)b * stride_u;
  const int tid = threadIdx.x;
  const int T = blockDim.x;

  // the row: head [0, h), body of nq 16-byte slots, tail [h + 4 nq, V)
  int h = 0;
  if constexpr (VEC) {
    h = static_cast<int>(((16u - (static_cast<unsigned int>(reinterpret_cast<uintptr_t>(lg)) & 15u)) &
                          15u) >> 2);
    h = min(h, V);
  }
  const int nq = (V - h) >> 2;
  const int per = (nq + C - 1) / C;
  const int q_lo = min(nq, rank * per);
  const int q_hi = min(nq, q_lo + per);
  const float* lb = lg + h;
  const float* ubb = ub + h;

  // one scalar element: head (rank 0, threads 0-2) or tail (last rank, 4-6),
  // loaded by every thread (element 0 where it has none, masked in the key)
  const int tail0 = h + 4 * nq;
  int e = -1;
  if (rank == 0 && tid < h) e = tid;
  if (rank == C - 1 && tid >= 4 && tail0 + tid - 4 < V) e = tail0 + tid - 4;
  const float el = ld_nc(lg + max(e, 0));
  const float eu = ld_nc(ub + max(e, 0));

  // rounds of R slots a thread; the next round's loads are issued before
  // this round's exp/log, so a thread always has loads in flight
  unsigned long long best = kNoKey;
  int q0 = q_lo + tid;
  if (q0 < q_hi) {
    float4 L[R], U[R];
    load_round<R, VEC>(lb, ubb, q0, T, q_hi - 1, L, U);
    for (;;) {
      const int qn = q0 + R * T;
      float4 Ln[R], Un[R];
      if (qn < q_hi) load_round<R, VEC>(lb, ubb, qn, T, q_hi - 1, Ln, Un);
      best = min(best, round_min<R>(L, U, h, q0, T, q_hi));
      if (qn >= q_hi) break;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        L[k] = Ln[k];
        U[k] = Un[k];
      }
      q0 = qn;
    }
  }
  best = min(best, e >= 0 ? tte_key(el, eu, e) : kNoKey);
  best = block_min_key(best, s_warp);

  if constexpr (CLUSTER) {
    cluster_wait();  // every block of the cluster has started
    if (tid == 0) store_to_rank(&s_rank[rank], 0, best);
    cluster_arrive_release();
    cluster_wait();  // rank 0 holds the C keys
    if (rank != 0) return;
    if (tid < 32) best = warp_min_key(tid < C ? s_rank[tid] : kNoKey);
  }
  if (tid == 0) {
    evt[b] = static_cast<int>(static_cast<unsigned int>(best));
    tmin[b] = __uint_as_float(static_cast<unsigned int>(best >> 32));
  }
}

using KernelFn = void (*)(const float*, const float*, long long, long long, int, int, int*,
                          float*);

template <bool VEC, bool CLUSTER>
KernelFn pick_r(int R) {
  switch (R) {
    case 1: return tte_sample_kernel<1, VEC, CLUSTER>;
    case 2: return tte_sample_kernel<2, VEC, CLUSTER>;
    default: return nullptr;
  }
}

KernelFn pick(int R, bool vec, bool cluster) {
  if (vec) return cluster ? pick_r<true, true>(R) : pick_r<true, false>(R);
  return cluster ? pick_r<false, true>(R) : pick_r<false, false>(R);
}

struct Plan {
  int cluster, r, threads;
};

// threads a block: enough for one round over its part of the row, in whole
// warps, at most 1024
int threads_for(int V, int C, int R) {
  const long long slots = ((long long)V + 3) / 4;
  const long long per_block = (slots + C - 1) / C;
  const long long want = (per_block + R - 1) / R;
  return static_cast<int>(std::min<long long>(1024, std::max<long long>(32, (want + 31) / 32 * 32)));
}

void cluster_attr(cudaLaunchAttribute& attr, int C) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
}

// The most clusters of C blocks of T threads of this instance the card holds
// at once (cudaOccupancyMaxActiveClusters), cached per device; 0 if the
// query fails.
int resident_clusters(int R, bool vec, int C, int T) {
  constexpr int kDevices = 16;
  static std::atomic<int> cache[kDevices][2][2][kMaxCluster + 1][33];  // value + 1
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kDevices) {
    cudaGetLastError();
    return 0;
  }
  std::atomic<int>& slot = cache[dev][R - 1][vec][C][T / 32];
  const int known = slot.load(std::memory_order_relaxed);
  if (known > 0) return known - 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(T);
  cudaLaunchAttribute attr[1];
  cluster_attr(attr[0], C);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(pick(R, vec, C > 1)),
                                     &cfg) != cudaSuccess) {
    cudaGetLastError();
    n = 0;
  }
  slot.store(n + 1, std::memory_order_relaxed);
  return n;
}

// Slots a thread takes a round: 4 elements (R = 1) up to V 4096, else 8.
// Blocks a row: from V, up to 1, 2, 4 or 8 (about one block per 4096 to
// 8191 elements); among 1 .. that many, the count C whose launch takes the
// fewest waves of resident clusters per C, i.e. the least time where a
// block's part of the row sets it (B 16 at V 256,206: 15 clusters of 8 fit
// at once, so 8 would take two waves; 6 takes one).
// The overrides must be valid (overrides_ok).
Plan plan_for(int B, int V, bool vec, int cluster, int per_thread) {
  Plan p;
  p.r = per_thread > 0 ? per_thread / 4 : (V <= 4096 ? 1 : 2);
  p.cluster = cluster > 0 ? cluster : 1;
  int cmax = 1;
  while (cluster == 0 && cmax < kMaxCluster && V / (4096 * cmax) >= 2) cmax *= 2;
  if (cmax > 1) {
    long long best_waves = -1;
    for (int c = 1; c <= cmax; ++c) {
      const int n = resident_clusters(p.r, vec, c, threads_for(V, c, p.r));
      if (n <= 0) continue;
      const long long waves = (B + n - 1) / n;
      if (best_waves < 0 || waves * p.cluster <= best_waves * c) {
        best_waves = waves;
        p.cluster = c;
      }
    }
  }
  p.threads = threads_for(V, p.cluster, p.r);
  return p;
}

bool overrides_ok(int cluster, int per_thread) {
  return cluster >= 0 && cluster <= kMaxCluster &&
         (per_thread == 0 || per_thread == 4 || per_thread == 8);
}

}  // namespace

// logits, u: (B, V) fp32 rows with unit element stride; evt (B,) int32,
// tmin (B,) fp32.  cluster (blocks per row, 1-8) and per_thread (elements a
// thread takes per round, 4 or 8): 0 picks by B and V (plan_for); set, they
// force that plan, for measurement.  Returns the cudaError_t of the launch,
// else of cudaGetLastError() after it.
extern "C" int tte_sample_launch(const void* logits, const void* u, long long stride_l,
                                 long long stride_u, int B, int V, void* evt, void* tmin,
                                 int cluster, int per_thread, void* stream) {
  if (!overrides_ok(cluster, per_thread)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const bool vec = ((reinterpret_cast<uintptr_t>(logits) ^ reinterpret_cast<uintptr_t>(u)) & 15u) == 0 &&
                   ((stride_l - stride_u) & 3) == 0;
  const Plan p = plan_for(B, V, vec, cluster, per_thread);
  const int C = p.cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(B) * C);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  cluster_attr(attr[0], C);
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, pick(p.r, vec, C > 1), static_cast<const float*>(logits), static_cast<const float*>(u),
      stride_l, stride_u, V, C, static_cast<int*>(evt), static_cast<float*>(tmin));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper raises on the returned code
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The plan tte_sample_launch takes for (B, V) rows whose logits and uniforms
// are aligned alike, under the given overrides, into out[0..3) (cluster,
// per_thread, threads), and how many clusters of that plan the card holds
// at once into out[3].  Returns a cudaError_t.
extern "C" int tte_sample_plan(int B, int V, int cluster, int per_thread, int* out) {
  if (!overrides_ok(cluster, per_thread)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan_for(B, V, true, cluster, per_thread);
  out[0] = p.cluster;
  out[1] = 4 * p.r;
  out[2] = p.threads;
  out[3] = resident_clusters(p.r, true, p.cluster, p.threads);
  return 0;
}
