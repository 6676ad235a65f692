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
// Design (rmsnorm_regs_kernel, one pass): a row is split into its 16-byte
// vectors (8 bf16 or 4 f32) and taken by TPR threads, VPT vectors each
// (vector v * TPR + t of the row goes to thread t, so a warp's loads are
// contiguous).  Every thread issues its VPT loads at once, keeps them in
// registers with the matching scale (read as float4), sums its squares,
// and the row's sum is reduced by warp shuffles (and across the row's
// warps through shared memory where TPR > 32); then x * inv_rms * scale
// is written from the registers.  VPT is a compile-time instance, 4, 5 or
// 7, the first for which TPR = vectors / VPT is a power of two up to 32
// or a multiple of 32 up to 512: no thread idles.  The zoo's rmsnorm
// widths:
//
//   d     bf16 VPT x TPR   f32 VPT x TPR
//   128   4 x 4            4 x 8          (smoke configs)
//   256   4 x 8            4 x 16
//   2048  4 x 64           4 x 128        (gemma_2b, olmoe_1b_7b)
//   2560  5 x 64           4 x 160        (zamba2-2.7b d_model)
//   3584  7 x 64           4 x 224        (qwen2_vl_7b)
//   5120  4 x 160          4 x 320        (zamba2-2.7b d_inner)
//   7168  4 x 224          4 x 448        (deepseek_coder_33b, kimi_k2)
//
// Narrow rows share a block (up to 256 threads), as few per block as keep
// ~2 blocks an SM busy, so a 4-row decode call spreads over 4 SMs.
//
// Other widths, and rows that are not 16-byte aligned, take
// rmsnorm_generic_kernel, chosen by shape: one block of 256 threads per
// row, two passes (the sum of squares, then the row re-read from L1/L2),
// 16-byte loads where the row allows them, else scalar ones.
#include "common.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

#define RN_THREADS 256  // generic kernel; most threads of a regs block
#define RN_MAX_TPR 512  // 128 registers a thread
#define RN_SMS 132      // H100 SXM

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

// sum of squares of one 16-byte vector, in f32
template <typename T>
__device__ __forceinline__ float sum_sq(const uint4& raw) {
  const T* e = reinterpret_cast<const T*>(&raw);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < Vec<T>::N; ++k) {
    const float f = to_f32(e[k]);
    s = fmaf(f, f, s);
  }
  return s;
}

// ---------------------------------------------------------------------------
// one pass from registers
// ---------------------------------------------------------------------------

// Block: rpb rows of tpr threads each (blockDim.x = rpb * tpr).
template <typename T, int VPT>
__global__ void __launch_bounds__(RN_MAX_TPR)
rmsnorm_regs_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    T* __restrict__ out, int rows, int d, int tpr,
                    float eps) {
  __shared__ float red[RN_MAX_TPR / 32];
  constexpr int V = Vec<T>::N;
  const int t = threadIdx.x % tpr;  // thread within its row
  const int rb = threadIdx.x / tpr;  // row within the block
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / tpr) + rb;
  const bool live = row < rows;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (live ? row : 0) * d);

  // every load of the row, and of the scale, in flight at once
  uint4 xv[VPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v)
    xv[v] = live ? xr[v * tpr + t] : make_uint4(0, 0, 0, 0);
  const float4* sc = reinterpret_cast<const float4*>(scale);
  float4 sv[VPT][V / 4];
#pragma unroll
  for (int v = 0; v < VPT; ++v)
#pragma unroll
    for (int q = 0; q < V / 4; ++q) sv[v][q] = sc[(v * tpr + t) * (V / 4) + q];
  float ss = 0.f;
#pragma unroll
  for (int v = 0; v < VPT; ++v) ss += sum_sq<T>(xv[v]);

  // the row's tpr threads: within a warp by shuffles (a row narrower than
  // a warp sits in an aligned lane group, so xor stays inside it)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    if (off < tpr) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (tpr > 32) {  // several warps per row: through shared memory
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    const float* mine = red + rb * (tpr / 32);
    for (int w = 0; w < tpr / 32; ++w) ss += mine[w];
  }
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  if (!live) return;

  uint4* orow = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    float s[V];
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 f = sv[v][q];
      s[4 * q] = f.x;
      s[4 * q + 1] = f.y;
      s[4 * q + 2] = f.z;
      s[4 * q + 3] = f.w;
    }
    const T* e = reinterpret_cast<const T*>(&xv[v]);
    uint4 res;
    T* o = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int k = 0; k < V; ++k) from_f32(o + k, to_f32(e[k]) * inv * s[k]);
    orow[v * tpr + t] = res;
  }
}

// ---------------------------------------------------------------------------
// generic widths: two passes
// ---------------------------------------------------------------------------

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
rmsnorm_generic_kernel(const T* __restrict__ x,
                       const float* __restrict__ scale, T* __restrict__ out,
                       int d, float eps) {
  __shared__ float sm[RN_THREADS / 32];
  const long long base = static_cast<long long>(blockIdx.x) * d;
  const T* xr = x + base;
  T* orow = out + base;
  constexpr int V = Vec<T>::N;

  float ss = 0.f;
  if (VEC) {
    const int nv = d / V;
    for (int i = threadIdx.x; i < nv; i += RN_THREADS)
      ss += sum_sq<T>(reinterpret_cast<const uint4*>(xr)[i]);
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

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// threads per row for VPT vectors each, or 0 where no thread count fits:
// a power of two up to 32, or a multiple of 32 up to RN_MAX_TPR
static int regs_tpr(int nvec, int vpt) {
  if (nvec % vpt != 0) return 0;
  const int tpr = nvec / vpt;
  if (tpr <= 32) return (tpr & (tpr - 1)) == 0 ? tpr : 0;
  return tpr % 32 == 0 && tpr <= RN_MAX_TPR ? tpr : 0;
}

template <typename T, int VPT>
static cudaError_t launch_regs(const void* x, const void* scale, void* out,
                               int rows, int d, int tpr, float eps,
                               cudaStream_t stream) {
  // as many rows per block as fit 256 threads, but no more than keep
  // ~2 blocks an SM: a few rows spread over as many SMs; a block is whole
  // warps (the shuffles take every lane)
  int rpb = tpr < RN_THREADS ? RN_THREADS / tpr : 1;
  const int spread = (rows + 2 * RN_SMS - 1) / (2 * RN_SMS);
  if (spread < rpb) rpb = spread;
  if (rpb * tpr < 32) rpb = 32 / tpr;
  const int blocks = (rows + rpb - 1) / rpb;
  rmsnorm_regs_kernel<T, VPT><<<blocks, rpb * tpr, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(out), rows, d, tpr, eps);
  return cudaGetLastError();
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
  if (vec && reinterpret_cast<uintptr_t>(scale) % 16 == 0) {
    const int nvec = d / Vec<T>::N;
    int tpr;
    if ((tpr = regs_tpr(nvec, 4)) > 0)
      return launch_regs<T, 4>(x, scale, out, rows, d, tpr, eps, stream);
    if ((tpr = regs_tpr(nvec, 5)) > 0)
      return launch_regs<T, 5>(x, scale, out, rows, d, tpr, eps, stream);
    if ((tpr = regs_tpr(nvec, 7)) > 0)
      return launch_regs<T, 7>(x, scale, out, rows, d, tpr, eps, stream);
  }
  if (vec)
    rmsnorm_generic_kernel<T, true><<<rows, RN_THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<T*>(out), d, eps);
  else
    rmsnorm_generic_kernel<T, false><<<rows, RN_THREADS, 0, stream>>>(
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
