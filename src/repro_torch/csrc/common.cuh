// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel file exposes one `extern "C"` launcher with a plain C
// interface (pointers and the stream as `void*`, sizes as `int`), loaded
// from Python through ctypes.  A launcher enqueues on the stream it is
// given, never synchronises, allocates nothing, and returns the value of
// cudaGetLastError() so the wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Opt a kernel into more than the default 48 KB of dynamic shared memory
// when a launch needs it (at most 227 KB on sm_90).
template <typename Kernel>
static inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// v rounded up to a multiple of 4 (a float4)
__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// acc += a * b, lane by lane: four independent FMA chains
__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// Store the first n (<= 4) lanes of v at dst: one 16-byte store when all
// four are wanted and dst is 16-byte aligned
__device__ __forceinline__ void store4(float* dst, const float4& v, int n) {
  if (n >= 4 && aligned16(dst)) {
    *reinterpret_cast<float4*>(dst) = v;
    return;
  }
  if (n > 0) dst[0] = v.x;
  if (n > 1) dst[1] = v.y;
  if (n > 2) dst[2] = v.z;
  if (n > 3) dst[3] = v.w;
}
