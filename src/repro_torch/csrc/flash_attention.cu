// flash_attention: blockwise streaming-softmax attention (forward only),
// causal and sliding-window masks, GQA by index.
//
//   s[b, i, j] = (q[b, i] . k[b / G, j]) * D^-0.5
//   masked to -1e30 unless  j < Sk
//                      and  (not causal or i + q_offset >= j)
//                      and  (window == 0 or i + q_offset - j < window)
//   out[b, i]  = sum_j softmax(s[b, i])_j * v[b / G, j],  q_offset = Sk - Sq
//   q (BH, Sq, D), k/v (BKV, Sk, D) -> out (BH, Sq, D), BH = BKV * G
//   f32 or bf16 in, f32 accumulation, output in q's type
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (body _flash_kernel): grid (BH, nq, nk) with the KV axis sequential and
// f32 (m, l, acc) scratch in VMEM, masks computed from program ids, GQA
// through the k/v index maps (KV never repeated in memory).
//
// What bounds it here: at training and prefill lengths, operations —
// 4 FLOPs per unmasked (query, key) pair per head element against bytes
// that grow only linearly in the sequence (at the stablelm_3b train_4k
// shape in chip_smoke.py, ~172 GFLOP against ~168 MB, bound ~0.17 ms at
// the bf16 tensor-core peak).  This first kernel does not reach the
// tensor cores: its products are f32 FFMA out of shared memory, so it
// runs far above that bound; a wgmma version is later work.
//
// Design: one block of 256 threads per (row b, tile of 32 queries), the
// tile order reversed so the longest causal tiles start first.  The q
// tile and each 32-key K/V tile sit in shared memory as f32 (rows padded
// by one word against bank conflicts); 8 threads share a query row, each
// holding 4 of the tile's 32 scores and 1/8 of the row's f32 accumulator
// in registers, with the row's running max and sum reduced by shuffles
// among the 8.  The loop over K/V tiles inside the block takes the place
// of the TPU's sequential KV grid axis; tiles that are masked for every
// query of the block (past the causal edge, or before the window) are
// skipped.  At D = 256 the tiles need ~101 KB, so the launch opts in to
// dynamic shared memory past 48 KB.  Masked scores use -1e30, not -inf:
// a row whose first tiles are fully masked (a sliding window) keeps a
// finite running max, and the correction exp(-1e30 - m) zeroes what it
// summed once a valid key arrives, as in the TPU kernel.
#include "common.cuh"

#include <cuda_bf16.h>
#include <math.h>

#define FA_BQ 32
#define FA_BK 32
#define FA_TPR 8  // threads per query row
#define FA_THREADS (FA_BQ * FA_TPR)
#define FA_MAX_D 256
#define FA_NEG -1e30f

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = FA_TPR / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = FA_TPR / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// NJ = accumulator columns per thread: D <= FA_TPR * NJ
template <typename T, int NJ>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int D, int q_per_kv, int causal, int window,
                       float scale) {
  extern __shared__ float smem[];
  constexpr int SC = FA_BK / FA_TPR;  // scores per thread per tile
  const int DP = D + 1;
  float* Qs = smem;                // (BQ, DP)
  float* Ks = Qs + FA_BQ * DP;     // (BK, DP)
  float* Vs = Ks + FA_BK * DP;     // (BK, DP)
  float* Ps = Vs + FA_BK * DP;     // (BQ, BK + 1)

  const int nq = (Sq + FA_BQ - 1) / FA_BQ;
  const int b = blockIdx.x / nq;
  const int tile = nq - 1 - (blockIdx.x - b * nq);
  const int q0 = tile * FA_BQ;
  const int t = threadIdx.x;
  const int r = t / FA_TPR;
  const int cl = t - r * FA_TPR;
  const int q_offset = Sk - Sq;
  const int qpos = q0 + r + q_offset;
  const T* qb = q + static_cast<long long>(b) * Sq * D;
  const long long kv_off = static_cast<long long>(b / q_per_kv) * Sk * D;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  for (int e = t; e < FA_BQ * D; e += FA_THREADS) {
    const int rr = e / D;
    const int d = e - rr * D;
    Qs[rr * DP + d] = (q0 + rr < Sq)
        ? load_f32(qb + static_cast<long long>(q0 + rr) * D + d) : 0.f;
  }

  // key range any query of this tile can see
  const int q_first = q0 + q_offset;
  const int q_last = min(q0 + FA_BQ, Sq) - 1 + q_offset;
  int kv_lo = 0, kv_hi = Sk;
  if (causal) kv_hi = min(Sk, q_last + 1);
  if (window > 0) kv_lo = max(0, q_first - window + 1);

  float m = FA_NEG, l = 0.f;
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;

  for (int k0 = (kv_lo / FA_BK) * FA_BK; k0 < kv_hi; k0 += FA_BK) {
    __syncthreads();  // the previous tile is consumed (and Qs is written)
    for (int e = t; e < FA_BK * D; e += FA_THREADS) {
      const int rr = e / D;
      const int d = e - rr * D;
      const bool ok = k0 + rr < Sk;
      const long long g = static_cast<long long>(k0 + rr) * D + d;
      Ks[rr * DP + d] = ok ? load_f32(kb + g) : 0.f;
      Vs[rr * DP + d] = ok ? load_f32(vb + g) : 0.f;
    }
    __syncthreads();

    float s[SC];
#pragma unroll
    for (int c = 0; c < SC; ++c) s[c] = 0.f;
    const float* qr = Qs + r * DP;
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int c = 0; c < SC; ++c)
        s[c] = fmaf(qd, Ks[(cl + FA_TPR * c) * DP + d], s[c]);
    }
    float mx = m;
#pragma unroll
    for (int c = 0; c < SC; ++c) {
      const int kpos = k0 + cl + FA_TPR * c;
      bool ok = kpos < Sk;
      if (causal) ok = ok && qpos >= kpos;
      if (window > 0) ok = ok && (qpos - kpos) < window;
      s[c] = ok ? s[c] * scale : FA_NEG;
      mx = fmaxf(mx, s[c]);
    }
    mx = row_max(mx);
    const float corr = expf(m - mx);
    float ps = 0.f;
    float* pr = Ps + r * (FA_BK + 1);
#pragma unroll
    for (int c = 0; c < SC; ++c) {
      const float p = expf(s[c] - mx);
      pr[cl + FA_TPR * c] = p;
      ps += p;
    }
    l = l * corr + row_sum(ps);
    m = mx;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] *= corr;
    __syncwarp();  // the row's 8 threads share one warp
    for (int c = 0; c < FA_BK; ++c) {
      const float p = pr[c];
      const float* vr = Vs + c * DP;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = cl + FA_TPR * j;
        if (d < D) acc[j] = fmaf(p, vr[d], acc[j]);
      }
    }
    __syncwarp();
  }

  if (q0 + r < Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = out + (static_cast<long long>(b) * Sq + q0 + r) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = cl + FA_TPR * j;
      if (d < D) store_f32(orow + d, acc[j] * inv);
    }
  }
}

template <typename T, int NJ>
static cudaError_t launch_flash(const void* q, const void* k, const void* v,
                                void* out, int BH, int Sq, int Sk, int D,
                                int q_per_kv, int causal, int window,
                                cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(FA_BQ + 2 * FA_BK) * (D + 1) +
                       static_cast<size_t>(FA_BQ) * (FA_BK + 1)) *
                      sizeof(float);
  cudaError_t err = allow_dynamic_smem(flash_attention_kernel<T, NJ>, smem);
  if (err != cudaSuccess) return err;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const long long nq = (Sq + FA_BQ - 1) / FA_BQ;
  const long long blocks = nq * BH;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_attention_kernel<T, NJ>
      <<<static_cast<unsigned>(blocks), FA_THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, D,
          q_per_kv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_flash(const void* q, const void* k, const void* v,
                                  void* out, int BH, int Sq, int Sk, int D,
                                  int q_per_kv, int causal, int window,
                                  cudaStream_t stream) {
  const int nj = (D + FA_TPR - 1) / FA_TPR;
#define FA_CASE(N)                                                        \
  if (nj <= N)                                                            \
    return launch_flash<T, N>(q, k, v, out, BH, Sq, Sk, D, q_per_kv,      \
                              causal, window, stream);
  FA_CASE(1)
  FA_CASE(2)
  FA_CASE(4)
  FA_CASE(8)
  FA_CASE(16)
#undef FA_CASE
  return launch_flash<T, 32>(q, k, v, out, BH, Sq, Sk, D, q_per_kv, causal,
                             window, stream);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it)
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int BH, int Sq, int Sk, int D,
                               int q_per_kv, int causal, int window,
                               int dtype, void* stream) {
  if (D < 1 || D > FA_MAX_D || q_per_kv < 1 || BH % q_per_kv != 0 ||
      window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || Sq == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(dispatch_flash<float>(
        q, k, v, out, BH, Sq, Sk, D, q_per_kv, causal, window, st));
  if (dtype == 1)
    return static_cast<int>(dispatch_flash<__nv_bfloat16>(
        q, k, v, out, BH, Sq, Sk, D, q_per_kv, causal, window, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
