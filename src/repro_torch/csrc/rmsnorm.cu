// rmsnorm: per-row RMS normalisation with a learned scale.
//
//   out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * scale
//   x (rows, d) f32 or bf16, scale (d,) f32 -> out (rows, d) in x's type
//   statistics and arithmetic in f32
//
// Replaces: src/repro/kernels/rmsnorm.py, rmsnorm_pallas (body
// _rmsnorm_kernel): a sequential grid over (128, d) row tiles, each
// normalised in VMEM with f32 statistics.
//
// What bounds it here: bytes.  Each element is read once and written once
// for ~4 FLOPs, two orders of magnitude below the H100's ridge point.  At
// the realistic shape in chip_smoke.py (prefill_32k x zamba2, batch cut
// to 2: 65536 rows of d = 5120, bf16) that is 1.34 GB, ~0.40 ms at
// 3.35 TB/s; at the decode shapes (4 rows) the launch is the cost.
//
// Design: one block of 256 threads per row; the TPU's row tile becomes
// the grid, which the card runs in parallel.  Pass 1 sums squares with
// 16-byte vector loads where the row is aligned (4 f32 or 8 bf16 per
// load), reduced by warp shuffles and then across the 8 warps through
// shared memory; pass 2 reads the row again (from L1/L2: a 10 KB row
// stays resident) and writes x * inv_rms * scale.  Rows whose width is
// not a multiple of the vector fall back to scalar loads.
#include "common.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

#define RN_THREADS 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// elements per 16-byte vector
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

// sum of v over the block's 256 threads, returned to every thread
__device__ __forceinline__ float block_sum(float v, float* sm) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) sm[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < RN_THREADS / 32; ++w) t += sm[w];
  return t;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(RN_THREADS)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int d, float eps) {
  __shared__ float sm[RN_THREADS / 32];
  const long long base = static_cast<long long>(blockIdx.x) * d;
  const T* xr = x + base;
  T* orow = out + base;
  constexpr int V = Vec<T>::N;

  float ss = 0.f;
  if (VEC) {
    const int nv = d / V;
    for (int i = threadIdx.x; i < nv; i += RN_THREADS) {
      const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float f = to_f32(e[k]);
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += RN_THREADS) {
      const float f = to_f32(xr[i]);
      ss = fmaf(f, f, ss);
    }
  }
  const float inv = rsqrtf(block_sum(ss, sm) / static_cast<float>(d) + eps);

  if (VEC) {
    const int nv = d / V;
    for (int i = threadIdx.x; i < nv; i += RN_THREADS) {
      const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int k = 0; k < V; ++k)
        from_f32(o + k, to_f32(e[k]) * inv * scale[i * V + k]);
      reinterpret_cast<uint4*>(orow)[i] = res;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += RN_THREADS)
      from_f32(orow + i, to_f32(xr[i]) * inv * scale[i]);
  }
}

template <typename T>
static cudaError_t launch_rmsnorm(const void* x, const void* scale, void* out,
                                  int rows, int d, float eps,
                                  cudaStream_t stream) {
  // 16-byte loads need a row width that is a multiple of the vector and
  // 16-byte aligned base pointers (torch allocations are 256-byte aligned;
  // every row then starts aligned because d * sizeof(T) is a multiple of 16)
  const bool vec = d % Vec<T>::N == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec)
    rmsnorm_kernel<T, true><<<rows, RN_THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<T*>(out), d, eps);
  else
    rmsnorm_kernel<T, false><<<rows, RN_THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<T*>(out), d, eps);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (x and out share it); scale is float32
extern "C" int rmsnorm(const void* x, const void* scale, void* out, int rows,
                       int d, int dtype, float eps, void* stream) {
  if (d < 1 || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(
        launch_rmsnorm<float>(x, scale, out, rows, d, eps, st));
  if (dtype == 1)
    return static_cast<int>(
        launch_rmsnorm<__nv_bfloat16>(x, scale, out, rows, d, eps, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
