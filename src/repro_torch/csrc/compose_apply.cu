// compose_apply: fused compose+apply for dense layers, y = x . (v . u).
//
//   W_a[i, d] = sum_r v[i, r] * u3[a, r, d]
//   y[m, d]   = sum_a sum_i xg[m, a, i] * W_a[i, d]
//   xg (M, g, I), v (I, R), u3 (g, R, D) -> y (M, D), f32
//
// Replaces: src/repro/kernels/compose.py, compose_apply_pallas (body
// _compose_apply_kernel), which builds each group's weight slice W_a in
// VMEM and contracts it with the matching input group in the same step.
//
// What bounds it here: the CNN's classifier head (M=16, g<=3, I=8, R=8,
// D=10) reads about 1.5 KB, writes 640 B and does about 10 kFLOP, so a
// call is bound by launch latency; past that by the bytes of xg and y.
//
// Design: a 2-D grid of (bm rows) x (dt output columns).  For each input
// group a the block builds its (I, dt) slice of W_a in shared memory and
// stages the (bm, I) rows of xg[:, a]; every thread then adds
// xg[:, a] . W_a into up to CA_ACC output accumulators held in registers.
// The composed p-width weight exists one group slice at a time, in shared
// memory only.  f32 FFMA accumulation, no TF32.
#include "common.cuh"

#define CA_THREADS 256
#define CA_ACC 4  // outputs per thread: bm * dt <= CA_THREADS * CA_ACC

__global__ void compose_apply_kernel(const float* __restrict__ xg,
                                     const float* __restrict__ v,
                                     const float* __restrict__ u3,
                                     float* __restrict__ y, int M, int g,
                                     int I, int R, int D, int bm, int dt) {
  extern __shared__ float smem[];
  float* w = smem;             // (I, dt): this group's weight slice
  float* xs = smem + I * dt;   // (bm, I): this group's input rows
  const int m0 = blockIdx.x * bm;
  const int d0 = blockIdx.y * dt;
  const int rows = min(bm, M - m0);
  const int cols = min(dt, D - d0);
  float acc[CA_ACC];
#pragma unroll
  for (int q = 0; q < CA_ACC; ++q) acc[q] = 0.f;
  for (int a = 0; a < g; ++a) {
    __syncthreads();  // the previous group's tiles are consumed
    for (int e = threadIdx.x; e < I * cols; e += blockDim.x) {
      const int i = e / cols;
      const int dd = e - i * cols;
      const float* ur = u3 + static_cast<long long>(a) * R * D + d0 + dd;
      float s = 0.f;
      for (int r = 0; r < R; ++r)
        s = fmaf(v[i * R + r], ur[static_cast<long long>(r) * D], s);
      w[i * dt + dd] = s;
    }
    for (int e = threadIdx.x; e < rows * I; e += blockDim.x) {
      const int mm = e / I;
      const int i = e - mm * I;
      xs[e] = xg[(static_cast<long long>(m0 + mm) * g + a) * I + i];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < CA_ACC; ++q) {
      const int e = threadIdx.x + q * blockDim.x;
      if (e < rows * cols) {
        const int mm = e / cols;
        const int dd = e - mm * cols;
        const float* xr = xs + mm * I;
        float s = acc[q];
        for (int i = 0; i < I; ++i) s = fmaf(xr[i], w[i * dt + dd], s);
        acc[q] = s;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < CA_ACC; ++q) {
    const int e = threadIdx.x + q * blockDim.x;
    if (e < rows * cols) {
      const int mm = e / cols;
      const int dd = e - mm * cols;
      y[static_cast<long long>(m0 + mm) * D + d0 + dd] = acc[q];
    }
  }
}

extern "C" int compose_apply_f32(const void* xg, const void* v,
                                 const void* u3, void* y, int M, int g, int I,
                                 int R, int D, int bm, int dt, void* stream) {
  if (M == 0 || D == 0) return static_cast<int>(cudaSuccess);
  if (bm * dt > CA_THREADS * CA_ACC)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = (static_cast<size_t>(I) * dt +
                       static_cast<size_t>(bm) * I) * sizeof(float);
  cudaError_t err = allow_dynamic_smem(compose_apply_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + bm - 1) / bm, (D + dt - 1) / dt);
  compose_apply_kernel<<<grid, CA_THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xg), static_cast<const float*>(v),
      static_cast<const float*>(u3), static_cast<float*>(y), M, g, I, R, D,
      bm, dt);
  return static_cast<int>(cudaGetLastError());
}
