// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel file exposes one `extern "C"` launcher with a plain C
// interface (pointers and the stream as `void*`, sizes as `int`), loaded
// from Python through ctypes.  A launcher enqueues on the stream it is
// given, never synchronises, allocates nothing, and returns the value of
// cudaGetLastError() so the wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>

// Opt a kernel into more than the default 48 KB of dynamic shared memory
// when a launch needs it (at most 227 KB on sm_90).
template <typename Kernel>
static inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
