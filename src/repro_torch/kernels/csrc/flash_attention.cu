// Causal / sliding-window / bidirectional GQA attention with an online
// softmax in fp32 (prefill attention of the serving path).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:86
// (flash_attention, body _flash_kernel).  The Pallas grid walked key blocks
// sequentially, carrying (acc, m, l) in VMEM across grid steps; here a block
// owns a tile of query rows of one (batch, query head) and loops over key
// tiles itself.  Key tiles wholly above the causal diagonal or below the
// sliding window are never loaded; the ragged S and T edges are masked in
// the kernel, so the wrapper pads nothing.  GQA reads key head h / G; the
// scale is hd^-0.5 of the true head width.  Two routes, chosen by dtype:
//
// bf16 (the serving path): tensor cores, mma.sync.m16n8k16 with bf16 inputs
// and fp32 sums.  A warp owns 16 query rows, a block 1-4 warps (16 * warps
// >= S where S <= 64, so two warps at S = 32), with the head zero-padded to
// HDP, the next multiple of 16.  The block's keys (all of them up to 256 at
// HDP <= 32, 128 at 64, 64 at 128) are staged in shared memory in one
// cp.async pass, issued before anything else so that their flight covers
// the reading of Q into A fragments and the setup of the masks; the pieces
// are 16, 8 or 4 bytes as the rows' alignment allows (q/k/v are transposed
// views of (B, S, H, hd): at hd 10 a row is 20 bytes at 20-byte offsets).
// Per 16 keys a warp forms S = Q K^T (8 keys per mma, K fragments by
// ldmatrix, their columns past hd masked to zeros in registers), masks it
// branch-free against each row's key range, runs the online softmax on the
// accumulators in registers (row max and sum over the quad of lanes that
// holds a row, 2^x on the SFU), rounds P to bf16 as the plain version does
// and feeds it straight back as the A fragment of P V (the m16n8
// accumulator layout is the A layout, pairwise), V fragments by
// ldmatrix.trans.  A warp skips the 16-key steps its rows cannot see.
//
// fp32 (the JAX signature's cases; the 2e-5 tolerance excludes bf16
// products): CUDA cores, one thread per query row in 64-row tiles, the row,
// its fp32 accumulator and its (m, l) in registers, the K/V tile staged in
// shared memory as fp32 and read by all 64 threads as broadcasts.
//
// Position masks (both routes, a template flag, so that the index route's
// code is unchanged): with q_pos (B, S) and k_pos (B, T) int32, key j is
// valid for query i iff k_pos[j] >= 0, q_pos[i] >= 0 and, when causal,
// k_pos[j] <= q_pos[i] and q_pos[i] - k_pos[j] < window.  This is the
// suffix prefill of chunked admission (replacing the JAX package's
// kernels/ops.py:86 suffix_prefill_attention, whose jnp route has no Pallas
// body): the chunk's queries over the gathered context plus the chunk.  A
// key's position comes from shared memory, staged with its K/V row; no key
// tile is skipped (index skipping is unsound when a key's index is not its
// position), and a key that the mask drops adds an exact 0 to the sums, so
// a chunk at the prompt head with no context gives the index route's bits.
// A query row with no valid key (q_pos -1: a chunk's padded tail) writes
// zeros.
//
// Bound on the card: at Delphi-2M's prefill shapes (hd = 10, S <= 256) the
// work is tiny (B 16, H 12, S 32: 0.5 MB, 0.15 us at 3.35 TB/s) and a call
// is its launch plus a chain of dependent steps in one warp: the staging
// and its round trip, the products, the softmax, the store.  The
// tensor-core route shortens the chain (a warp does 2 * (S / 16) products
// per 16 rows where a thread did 2 * S * HDP FMAs in series); what is left
// is latency, not bytes or operations (PERF.md).
#include <algorithm>
#include <cmath>

#include "common.cuh"

constexpr int FA_BQ = 64;  // query rows (= threads) per block of the fp32 route

struct Strides {
  long long b, h, s;  // element strides of the batch, head and row axes; unit stride inside a row
};

// ---------------------------------------------------------------------------
// Tensor-core route: bf16.
// ---------------------------------------------------------------------------
constexpr int FM_MAX_WARPS = 4;  // query rows per block <= 64
constexpr int FM_BK = 64;        // keys a warp takes at a time

// stage rows [k0, k0 + n) of one head of k and of v into rows 0.. of k_s
// and v_s (row stride LDS), in cp.async pieces of CPB bytes (16, 8 or 4; 0:
// element by element); V's rows at or past T are written as zeros (K's
// there only give masked scores).  A thread's first piece costs a division;
// the next ones are strided by the block.
template <int LDS, int CPB>
__device__ __forceinline__ void stage_kv_pieces(__nv_bfloat16* k_s, __nv_bfloat16* v_s,
                                                const __nv_bfloat16* kp, const __nv_bfloat16* vp,
                                                long long krs, long long vrs, int k0, int n, int T,
                                                int hd) {
  constexpr int EP = CPB ? CPB / 2 : 1;  // elements per piece
  const int per_row = hd / EP;
  const int dr = blockDim.x / per_row;  // a sweep of the block advances dr rows, dc pieces
  const int dc = blockDim.x % per_row;
  const uint32_t k_base = smem_addr(k_s);
  const uint32_t v_base = smem_addr(v_s);
  int r = threadIdx.x / per_row;
  int c = threadIdx.x % per_row;
  for (; r < n; r += dr, c += dc) {
    if (c >= per_row) {
      c -= per_row;
      if (++r >= n) break;
    }
    const int e0 = r * LDS + c * EP;  // element offset in the tile
    const int row = k0 + r;
    if (row >= T) {
#pragma unroll
      for (int e = 0; e < EP; ++e) v_s[e0 + e] = __float2bfloat16_rn(0.f);
    } else if constexpr (CPB > 0) {
      cp_async<CPB>(k_base + 2 * e0, kp + row * krs + c * EP);
      cp_async<CPB>(v_base + 2 * e0, vp + row * vrs + c * EP);
    } else {
      k_s[e0] = kp[row * krs + c];
      v_s[e0] = vp[row * vrs + c];
    }
  }
}

template <int LDS>
__device__ __forceinline__ void stage_kv(__nv_bfloat16* k_s, __nv_bfloat16* v_s,
                                         const __nv_bfloat16* kp, const __nv_bfloat16* vp,
                                         long long krs, long long vrs, int k0, int n, int T,
                                         int hd, int cpb) {
  if (cpb == 16)
    stage_kv_pieces<LDS, 16>(k_s, v_s, kp, vp, krs, vrs, k0, n, T, hd);
  else if (cpb == 8)
    stage_kv_pieces<LDS, 8>(k_s, v_s, kp, vp, krs, vrs, k0, n, T, hd);
  else if (cpb == 4)
    stage_kv_pieces<LDS, 4>(k_s, v_s, kp, vp, krs, vrs, k0, n, T, hd);
  else
    stage_kv_pieces<LDS, 0>(k_s, v_s, kp, vp, krs, vrs, k0, n, T, hd);
}

// stage the positions of keys [k0, k0 + n) into kp_s (-1 past T)
__device__ __forceinline__ void stage_pos(int* kp_s, const int* kp, int k0, int n, int T) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) kp_s[r] = k0 + r < T ? kp[k0 + r] : -1;
}

// key at position kp valid for a query at position qp (position masks)
__device__ __forceinline__ bool pos_valid(int qp, int kp, int causal, int window) {
  bool ok = (kp >= 0) & (qp >= 0);
  if (causal) ok = ok & (kp <= qp) & ((window <= 0) | (qp - kp < window));
  return ok;
}

template <int HDP, bool POS>
__global__ void __launch_bounds__(FM_MAX_WARPS * 32)
    flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                               const int* __restrict__ qpos, const int* __restrict__ kpos,
                               Strides sq, Strides sk, Strides sv, Strides so, int G, int S, int T,
                               int hd, float scale, int causal, int window, int cpb) {
  constexpr int LDS = HDP + 8;  // row stride: ldmatrix's 8 rows on 8 bank groups
  constexpr int NK = HDP / 16;  // 16-wide steps over the head
  constexpr int ND = HDP / 8;   // 8-wide output tiles over the head
  constexpr int NS = FM_BK / 16;
  // keys staged per pass (one cp.async round trip): a block's whole key
  // range up to 256 keys at hd <= 32, within 48 KB of static shared memory
  constexpr int BKS = HDP <= 32 ? 256 : HDP == 64 ? 128 : 64;
  __shared__ __align__(16) __nv_bfloat16 k_s[BKS * LDS];
  __shared__ __align__(16) __nv_bfloat16 v_s[BKS * LDS];
  __shared__ int kp_s[POS ? BKS : 1];  // the staged keys' positions

  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;  // accumulator row (and +8)
  const int tq = lane & 3;   // accumulator column pair
  const int q0 = blockIdx.x * nw * 16;
  const int r0 = q0 + warp * 16;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / G;

  // keys the block stages: [kb, ke16); the warp's rows see keys [wlo, whi)
  int kb = 0, ke = T, wlo = 0, whi = T;
  if (causal && !POS) {
    ke = min(T, q0 + nw * 16);
    whi = min(T, r0 + 16);
    if (window > 0) {
      kb = max(0, q0 - window + 1) & ~15;
      wlo = max(0, r0 - window + 1);
    }
  }
  const int ke16 = (ke + 15) & ~15;

  // the first pass's K/V go in flight before everything else below
  const __nv_bfloat16* kp = k + b * sk.b + hk * sk.h;
  const __nv_bfloat16* vp = v + b * sv.b + hk * sv.h;
  stage_kv<LDS>(k_s, v_s, kp, vp, sk.s, sv.s, kb, min(BKS, ke16 - kb), T, hd, cpb);
  if constexpr (POS) stage_pos(kp_s, kpos + (long long)b * T, kb, min(BKS, ke16 - kb), T);

  // K's columns past hd hold whatever shared memory held (cp.async writes
  // only the first hd): their B fragments are masked to zeros in registers,
  // since Q's are zeros and 0 * NaN is NaN.  V's columns past hd reach only
  // output columns that are not stored, and K's rows past T only masked
  // scores; V's rows past T are zeroed when they are staged (p = 0 there).
  uint32_t kmask[NK][2];
#pragma unroll
  for (int kc = 0; kc < NK; ++kc)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int d = kc * 16 + hf * 8 + 2 * tq;
      kmask[kc][hf] = (d < hd ? 0xffffu : 0u) | (d + 1 < hd ? 0xffff0000u : 0u);
    }
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units: p = 2^(s - m)
  // the keys rows r0 + gr and r0 + gr + 8 see: [klo, khi) by index, or
  // by position against the rows' positions qp (-1 past S)
  int klo[2], khi[2], qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + gr + 8 * i;
    khi[i] = causal ? min(T, row + 1) : T;
    klo[i] = causal && window > 0 ? row - window + 1 : 0;
    if constexpr (POS) qp[i] = row < S ? qpos[(long long)b * S + row] : -1;
  }

  // Q as A fragments, rows r0 + gr and r0 + gr + 8, zeros past S and hd
  uint32_t qa[NK][4];
  {
    const __nv_bfloat16* qp = q + b * sq.b + h * sq.h;
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
    for (int kc = 0; kc < NK; ++kc) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int r = r0 + gr + (f & 1) * 8;
        const int c = kc * 16 + (f >> 1) * 8 + 2 * tq;
        const __nv_bfloat16* p = qp + (long long)r * sq.s + c;
        const bool rok = r < S;
        qa[kc][f] = pack_bf16(rok && c < hd ? p[0] : zero, rok && c + 1 < hd ? p[1] : zero);
      }
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows gr, gr + 8
  float l[2] = {0.f, 0.f};              // this lane's share of the row sums

  for (int k0 = kb; k0 < ke16; k0 += BKS) {
    const int n = min(BKS, ke16 - k0);
    if (k0 != kb) {
      stage_kv<LDS>(k_s, v_s, kp, vp, sk.s, sv.s, k0, n, T, hd, cpb);
      if constexpr (POS) stage_pos(kp_s, kpos + (long long)b * T, k0, n, T);
    }
    cp_async_wait_all();
    __syncthreads();

    // the staged keys, 64 at a time
    for (int c0 = 0; c0 < n; c0 += FM_BK) {
      if (k0 + c0 >= whi) break;              // warp-uniform: past the diagonal
      if (k0 + c0 + FM_BK <= wlo) continue;   // before the window
      // S = Q K^T for the 16-key steps this warp's rows can see
      float sc[NS][2][4];
      bool live[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int ks = k0 + c0 + 16 * j;
        live[j] = ks < whi && ks + 16 > wlo && c0 + 16 * j < n;
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][t][e] = 0.f;
        if (live[j]) {  // warp-uniform
#pragma unroll
          for (int kc = 0; kc < NK; ++kc) {
            uint32_t kf[4];
            const int row = c0 + 16 * j + (lane & 7) + ((lane >> 4) << 3);
            ldmatrix_x4(kf, k_s + row * LDS + kc * 16 + ((lane >> 3) & 1) * 8);
            kf[0] &= kmask[kc][0];
            kf[1] &= kmask[kc][1];
            kf[2] &= kmask[kc][0];
            kf[3] &= kmask[kc][1];
            mma_bf16(sc[j][0], qa[kc], kf[0], kf[1]);
            mma_bf16(sc[j][1], qa[kc], kf[2], kf[3]);
          }
        }
      }

      // scale, mask and the row max over these 64 keys
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        if (!live[j]) continue;  // warp-uniform
        const int ks = k0 + c0 + 16 * j;
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = ks + 8 * t + 2 * tq + (e & 1);
            const int i = e >> 1;
            bool ok;
            if constexpr (POS)
              ok = pos_valid(qp[i], kp_s[key - k0], causal, window);
            else
              ok = (key >= klo[i]) & (key < khi[i]);
            const float x = ok ? sc[j][t][e] * sl2 : -INFINITY;
            sc[j][t][e] = x;
            mx[i] = fmaxf(mx[i], x);
          }
      }
      float alpha[2], mu[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        mu[i] = m_new == -INFINITY ? 0.f : m_new;  // nothing seen yet: p = 0
        alpha[i] = fast_exp2(m[i] - mu[i]);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e >> 1];

      // P (bf16) V, P taken from the accumulators as A fragments
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        if (!live[j]) continue;  // warp-uniform
        uint32_t pa[4];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          __nv_bfloat16 pb[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pb[e] = __float2bfloat16_rn(fast_exp2(sc[j][t][e] - mu[e >> 1]));
            l[e >> 1] += __bfloat162float(pb[e]);
          }
          pa[2 * t] = pack_bf16(pb[0], pb[1]);      // row gr
          pa[2 * t + 1] = pack_bf16(pb[2], pb[3]);  // row gr + 8
        }
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          uint32_t vf[4];
          const int row = c0 + 16 * j + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldmatrix_x4_trans(vf, v_s + row * LDS + nd * 8 + (lane >> 4) * 8);
          mma_bf16(acc[nd], pa, vf[0], vf[1]);
          mma_bf16(acc[nd + 1], pa, vf[2], vf[3]);
        }
      }
    }
    if (k0 + BKS < ke16) __syncthreads();  // before the next pass restages
  }

  // row sums over the quad, then the output rows gr and gr + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = __frcp_rn(fmaxf(l[i], 1e-30f));
  }
  __nv_bfloat16* op = o + b * so.b + h * so.h;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + gr + (e >> 1) * 8;
      const int c = nd * 8 + 2 * tq + (e & 1);
      if (row < S && c < hd) op[(long long)row * so.s + c] = __float2bfloat16_rn(acc[nd][e] * l[e >> 1]);
    }
}

// largest cp.async piece (16, 8 or 4 bytes) that every bf16 row of t starts
// on and that divides the row: 0 where none does (odd hd)
static int copy_bytes(const void* p, const Strides& st, int hd) {
  const unsigned long long a = reinterpret_cast<uintptr_t>(p) |
                               static_cast<unsigned long long>(st.b * 2) |
                               static_cast<unsigned long long>(st.h * 2) |
                               static_cast<unsigned long long>(st.s * 2) |
                               static_cast<unsigned long long>(hd * 2);
  for (int c = 16; c >= 4; c >>= 1)
    if (a % c == 0) return c;
  return 0;
}

template <int HDP>
static int launch_flash_mma(const void* q, const void* k, const void* v, void* o,
                            const int* qpos, const int* kpos, const Strides* st, int B, int Hq,
                            int G, int S, int T, int hd, float scale, int causal, int window,
                            cudaStream_t stream) {
  const int nw = std::min(FM_MAX_WARPS, (S + 15) / 16);
  const dim3 grid((S + 16 * nw - 1) / (16 * nw), Hq, B);
  const int cpb = std::min(copy_bytes(k, st[1], hd), copy_bytes(v, st[2], hd));
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  if (qpos)
    flash_attention_mma_kernel<HDP, true><<<grid, 32 * nw, 0, stream>>>(
        qb, kb, vb, ob, qpos, kpos, st[0], st[1], st[2], st[3], G, S, T, hd, scale, causal,
        window, cpb);
  else
    flash_attention_mma_kernel<HDP, false><<<grid, 32 * nw, 0, stream>>>(
        qb, kb, vb, ob, nullptr, nullptr, st[0], st[1], st[2], st[3], G, S, T, hd, scale, causal,
        window, cpb);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// CUDA-core route: fp32.
// ---------------------------------------------------------------------------

template <int HDP, int BK, bool POS>
__global__ void __launch_bounds__(FA_BQ)
    flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           const int* __restrict__ qpos, const int* __restrict__ kpos,
                           Strides sq, Strides sk, Strides sv, Strides so, int G, int S, int T,
                           int hd, float scale, int causal, int window) {
  __shared__ float k_s[BK][HDP];
  __shared__ float v_s[BK][HDP];
  __shared__ int kp_s[POS ? BK : 1];
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
    qr[d] = (row_ok && d < hd) ? q[qoff + d] : 0.f;
    acc[d] = 0.f;
  }

  const int qp = POS && row_ok ? qpos[(long long)b * S + row] : -1;

  // key range this query tile can see; whole tiles outside it are skipped
  // (by index: with positions every tile is visited)
  int k_begin = 0;
  int k_end = T;
  if (causal && !POS) {
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
      k_s[j][d] = ok ? k[kb + (long long)kj * sk.s + d] : 0.f;
      v_s[j][d] = ok ? v[vb + (long long)kj * sv.s + d] : 0.f;
    }
    if constexpr (POS) stage_pos(kp_s, kpos + (long long)b * T, k0, BK, T);
    __syncthreads();

    float s[BK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int kj = k0 + j;
      bool valid = kj < T;
      if constexpr (POS) {
        valid = pos_valid(qp, kp_s[j], causal, window);
      } else if (causal) {
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
      if (d < hd) o[ooff + d] = acc[d] / denom;
  }
}

template <int HDP, int BK>
static int launch_flash(const void* q, const void* k, const void* v, void* o, const int* qpos,
                        const int* kpos, const Strides* st, int B, int Hq, int G, int S, int T,
                        int hd, float scale, int causal, int window, cudaStream_t stream) {
  const dim3 grid((S + FA_BQ - 1) / FA_BQ, Hq, B);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  if (qpos)
    flash_attention_kernel<HDP, BK, true><<<grid, FA_BQ, 0, stream>>>(
        qf, kf, vf, of, qpos, kpos, st[0], st[1], st[2], st[3], G, S, T, hd, scale, causal,
        window);
  else
    flash_attention_kernel<HDP, BK, false><<<grid, FA_BQ, 0, stream>>>(
        qf, kf, vf, of, nullptr, nullptr, st[0], st[1], st[2], st[3], G, S, T, hd, scale, causal,
        window);
  return static_cast<int>(cudaGetLastError());
}

// q: (B, Hq, S, hd), k/v: (B, Hkv, T, hd), o: (B, Hq, S, hd), all of one
// dtype (REPRO_F32 or REPRO_BF16), any batch/head/row strides with unit
// stride along hd.  strides: 12 element strides (b, h, s) of q, k, v, o.
// window <= 0 means no sliding window.  qpos (B, S) and kpos (B, T):
// contiguous int32 positions (-1 = invalid) that mask by position, or both
// null to mask by index.  Returns cudaGetLastError().
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                      void* o, const int* qpos, const int* kpos,
                                      const long long* strides, int B, int Hq, int Hkv, int S,
                                      int T, int hd, float scale, int causal, int window,
                                      void* stream) {
  if (B == 0 || S == 0) return 0;
  if (dtype != REPRO_F32 && dtype != REPRO_BF16) return static_cast<int>(cudaErrorInvalidValue);
  if ((qpos == nullptr) != (kpos == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int G = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16) {
    if (hd <= 16)
      return launch_flash_mma<16>(q, k, v, o, qpos, kpos, st, B, Hq, G, S, T, hd, scale, causal,
                                  window, s);
    if (hd <= 32)
      return launch_flash_mma<32>(q, k, v, o, qpos, kpos, st, B, Hq, G, S, T, hd, scale, causal,
                                  window, s);
    if (hd <= 64)
      return launch_flash_mma<64>(q, k, v, o, qpos, kpos, st, B, Hq, G, S, T, hd, scale, causal,
                                  window, s);
    if (hd <= 128)
      return launch_flash_mma<128>(q, k, v, o, qpos, kpos, st, B, Hq, G, S, T, hd, scale, causal,
                                   window, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (hd <= 16)
    return launch_flash<16, 32>(q, k, v, o, qpos, kpos, st, B, Hq, G, S, T, hd, scale, causal,
                                window, s);
  if (hd <= 32)
    return launch_flash<32, 32>(q, k, v, o, qpos, kpos, st, B, Hq, G, S, T, hd, scale, causal,
                                window, s);
  if (hd <= 64)
    return launch_flash<64, 16>(q, k, v, o, qpos, kpos, st, B, Hq, G, S, T, hd, scale, causal,
                                window, s);
  if (hd <= 128)
    return launch_flash<128, 8>(q, k, v, o, qpos, kpos, st, B, Hq, G, S, T, hd, scale, causal,
                                window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
