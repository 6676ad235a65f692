// ssd_chunk: the Mamba2 SSD intra-chunk block plus the carry-in of the
// state entering the chunk, for one (batch, chunk, head) row per block.
//
//   w[i, j] = (C[i] . B[j]) * exp(cum[i] - cum[j])   for j <= i, else 0
//   y[i]    = sum_j round_T(w[i, j]) * xw[j]  +  exp(cum[i]) * (C[i] . h_in)
//   cb/bb (R / heads, Q, N), xw (R, Q, P), h_in (R, N, P) in T (f32 or
//   bf16); cum (R, Q) f32 -> y (R, Q, P) in T.  Row r reads C and B of
//   row r / heads: the heads of one (batch, chunk) share B and C (Mamba2's
//   single group), so they are passed once and never replicated.
//   f32 accumulation; w is rounded to T before w . xw, as the TPU kernel
//   casts it to xw's type before its second matmul.
//
// Replaces: src/repro/kernels/ssd_chunk.py, ssd_chunk_pallas (body
// _ssd_kernel): grid (BCH,), each cell a (Q, Q) score matmul on the MXU,
// the causal decay applied in VMEM, a (Q, Q) x (Q, P) matmul and the
// (Q, N) x (N, P) carry, all with f32 accumulation.
//
// What bounds it here: at the realistic shape in chip_smoke.py
// (prefill_32k x zamba2 with the batch cut to 2: 20480 rows of Q = 256,
// N = P = 64, bf16) the causal half of the two Q x Q products plus the
// carry is ~216 GFLOP against ~1.5 GB of unique bytes, so in bf16 on
// tensor cores it would be bound by bytes (~0.46 ms) and in f32 FFMA by
// operations (~3.2 ms at 67 TFLOP/s).  This kernel is f32 FFMA out of
// shared memory (no tensor cores), so it is bound by operations.
//
// Design: one block of 256 threads per row; the TPU's (Q, Q) score tile
// (256 KB in f32 at Q = 256, more than a block's shared memory) is cut
// into 64 x 64 tiles.  For each 64-row query tile i the block keeps C_i
// (transposed, N x 64) in shared memory and the 64 x P output tile in
// registers (a 4 x 4 micro-tile per thread), starts it at the carry-in
// exp(cum_i) * C_i . h_in, then walks the key tiles j <= i only (the
// upper triangle is never computed): S = C_i . B_j^T into registers, the
// decay and the causal mask applied there (masked entries are set to 0
// without evaluating exp, so no inf * 0 = NaN), w rounded to T and
// written transposed to shared memory, then acc += w . xw_j.  Shared
// memory is ~85 KB at N = 64 (dynamic, opted in past 48 KB).  Sizes:
// N <= 128, P <= 64, any Q; the edges are zero-filled and masked.
#include "common.cuh"

#include <cuda_bf16.h>
#include <math.h>

#define SSD_THREADS 256
#define SSD_T 64           // query and key tile
#define SSD_LD (SSD_T + 4)  // padded leading dim of transposed tiles
#define SSD_PT 64          // output columns held per block (P <= 64)
#define SSD_MAX_N 128

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store_t(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_t(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

static size_t ssd_smem_floats(int N) {
  return 2 * static_cast<size_t>(N) * SSD_LD  // C_i^T, B_j^T
         + SSD_T * SSD_LD                      // w^T
         + SSD_T * SSD_PT                      // xw_j
         + static_cast<size_t>(N) * SSD_PT     // h_in
         + 2 * SSD_T;                          // cum_i, cum_j
}

template <typename T>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_chunk_kernel(const T* __restrict__ cb, const T* __restrict__ bb,
                 const T* __restrict__ xw, const float* __restrict__ cum,
                 const T* __restrict__ hin, T* __restrict__ out, int Q, int N,
                 int P, int heads) {
  extern __shared__ float4 smem4[];
  float* Ct = reinterpret_cast<float*>(smem4);  // [N][SSD_LD]
  float* Bt = Ct + N * SSD_LD;                  // [N][SSD_LD]
  float* Wt = Bt + N * SSD_LD;                  // [SSD_T][SSD_LD]: w^T
  float* Xs = Wt + SSD_T * SSD_LD;              // [SSD_T][SSD_PT]
  float* Hs = Xs + SSD_T * SSD_PT;              // [N][SSD_PT]
  float* ci = Hs + N * SSD_PT;                  // [SSD_T]
  float* cj = ci + SSD_T;                       // [SSD_T]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // 16 x 16 threads, 4 x 4 each
  const long long r = blockIdx.x;
  const long long g = r / heads;
  const T* cbr = cb + g * Q * N;
  const T* bbr = bb + g * Q * N;
  const T* xwr = xw + r * Q * P;
  const float* cumr = cum + r * Q;
  const T* hr = hin + r * N * P;
  T* outr = out + r * Q * P;

  for (int idx = tid; idx < N * SSD_PT; idx += SSD_THREADS) {
    const int n = idx / SSD_PT, p = idx % SSD_PT;
    Hs[idx] = p < P ? to_f32(hr[n * P + p]) : 0.f;
  }

  for (int i0 = 0; i0 < Q; i0 += SSD_T) {
    __syncthreads();  // the previous query tile is done with Ct and ci
    for (int idx = tid; idx < SSD_T * N; idx += SSD_THREADS) {
      const int i = idx / N, n = idx % N;
      Ct[n * SSD_LD + i] = i0 + i < Q ? to_f32(cbr[(i0 + i) * N + n]) : 0.f;
    }
    for (int i = tid; i < SSD_T; i += SSD_THREADS)
      ci[i] = i0 + i < Q ? cumr[i0 + i] : 0.f;
    __syncthreads();

    // carry-in: acc = exp(cum_i) * (C_i . h_in)
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
    for (int n = 0; n < N; ++n) {
      const float4 ca = *reinterpret_cast<const float4*>(Ct + n * SSD_LD +
                                                         ty * 4);
      const float4 hb = *reinterpret_cast<const float4*>(Hs + n * SSD_PT +
                                                         tx * 4);
      const float av[4] = {ca.x, ca.y, ca.z, ca.w};
      const float bv[4] = {hb.x, hb.y, hb.z, hb.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float e = expf(ci[ty * 4 + a]);
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] *= e;
    }

    // key tiles on or below the diagonal
    for (int j0 = 0; j0 <= i0 && j0 < Q; j0 += SSD_T) {
      __syncthreads();  // everyone is done reading Bt, Xs, Wt, cj
      for (int idx = tid; idx < SSD_T * N; idx += SSD_THREADS) {
        const int j = idx / N, n = idx % N;
        Bt[n * SSD_LD + j] = j0 + j < Q ? to_f32(bbr[(j0 + j) * N + n]) : 0.f;
      }
      for (int idx = tid; idx < SSD_T * SSD_PT; idx += SSD_THREADS) {
        const int j = idx / SSD_PT, p = idx % SSD_PT;
        Xs[idx] = (j0 + j < Q && p < P) ? to_f32(xwr[(j0 + j) * P + p]) : 0.f;
      }
      for (int j = tid; j < SSD_T; j += SSD_THREADS)
        cj[j] = j0 + j < Q ? cumr[j0 + j] : 0.f;
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float4 ca = *reinterpret_cast<const float4*>(Ct + n * SSD_LD +
                                                           ty * 4);
        const float4 bj = *reinterpret_cast<const float4*>(Bt + n * SSD_LD +
                                                           tx * 4);
        const float av[4] = {ca.x, ca.y, ca.z, ca.w};
        const float bv[4] = {bj.x, bj.y, bj.z, bj.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) s[a][b] = fmaf(av[a], bv[b], s[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty * 4 + a;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = tx * 4 + b;
          const bool live = j0 + j <= i0 + i && j0 + j < Q;
          const float w = live ? s[a][b] * expf(ci[i] - cj[j]) : 0.f;
          Wt[j * SSD_LD + i] = round_to(w, xw);
        }
      }
      __syncthreads();

      for (int j = 0; j < SSD_T; ++j) {
        const float4 wa = *reinterpret_cast<const float4*>(Wt + j * SSD_LD +
                                                           ty * 4);
        const float4 xb = *reinterpret_cast<const float4*>(Xs + j * SSD_PT +
                                                           tx * 4);
        const float av[4] = {wa.x, wa.y, wa.z, wa.w};
        const float bv[4] = {xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
      }
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty * 4 + a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int p = tx * 4 + b;
        if (i < Q && p < P) store_t(outr + static_cast<long long>(i) * P + p,
                                    acc[a][b]);
      }
    }
  }
}

// Opt in once, for the largest N, before any launch: the first call
// happens eagerly, so a later launch inside a CUDA-graph capture makes no
// attribute call.
template <typename T>
static cudaError_t ensure_smem_attr() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t e = allow_dynamic_smem(
      ssd_chunk_kernel<T>, ssd_smem_floats(SSD_MAX_N) * sizeof(float));
  done = e == cudaSuccess;
  return e;
}

template <typename T>
static cudaError_t launch_ssd(const void* cb, const void* bb, const void* xw,
                              const void* cum, const void* hin, void* out,
                              int R, int Q, int N, int P, int heads,
                              cudaStream_t stream) {
  const size_t smem = ssd_smem_floats(N) * sizeof(float);
  const cudaError_t e = ensure_smem_attr<T>();
  if (e != cudaSuccess) return e;
  ssd_chunk_kernel<T><<<R, SSD_THREADS, smem, stream>>>(
      static_cast<const T*>(cb), static_cast<const T*>(bb),
      static_cast<const T*>(xw), static_cast<const float*>(cum),
      static_cast<const T*>(hin), static_cast<T*>(out), Q, N, P, heads);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (cb, bb, xw, h_in and out share it;
// cum is float32).  R = rows of xw / cum / h_in / out; cb and bb hold
// R / heads rows.
extern "C" int ssd_chunk(const void* cb, const void* bb, const void* xw,
                         const void* cum, const void* hin, void* out, int R,
                         int Q, int N, int P, int heads, int dtype,
                         void* stream) {
  if (Q < 1 || N < 1 || N > SSD_MAX_N || P < 1 || P > SSD_PT || heads < 1 ||
      R % heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_ssd<float>(cb, bb, xw, cum, hin, out, R,
                                              Q, N, P, heads, st));
  if (dtype == 1)
    return static_cast<int>(launch_ssd<__nv_bfloat16>(
        cb, bb, xw, cum, hin, out, R, Q, N, P, heads, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
