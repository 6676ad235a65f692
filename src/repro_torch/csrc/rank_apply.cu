// rank_apply: the fused rank-space dense application y = (x . v) . u2.
//
//   t[m, a*R + r] = sum_i xg[m, a, i] * v[i, r]
//   y[m, d]       = sum_q t[m, q] * u2[q, d]
//   xg (M, g, I), v (I, R), u2 (g*R, D) -> y (M, D), f32
//
// Replaces: src/repro/kernels/compose.py, rank_apply_pallas (body
// _rank_apply_kernel), which keeps the (bm, g*R) rank intermediate in
// VMEM between its two MXU matmuls.
//
// What bounds it here: the CNN's classifier head (M=16, g<=3, I=8, R=8,
// D=10) reads and writes about 2 KB and does about 10 kFLOP, so a call is
// bound by launch latency; past that by the bytes of xg and y.
//
// Design: one block per bm rows.  Stage 1 computes the block's rank tile
// t = xg . v into shared memory (one thread per (row, group, r) entry);
// stage 2 contracts it with u2 straight out of shared memory (one thread
// per output (row, d)).  The rank intermediate never reaches device
// memory, as in the TPU kernel.  f32 FFMA accumulation, no TF32.
#include "common.cuh"

__global__ void rank_apply_kernel(const float* __restrict__ xg,
                                  const float* __restrict__ v,
                                  const float* __restrict__ u2,
                                  float* __restrict__ y, int M, int g, int I,
                                  int R, int D, int bm) {
  extern __shared__ float t[];  // (bm, g*R)
  const int gR = g * R;
  const int m0 = blockIdx.x * bm;
  const int rows = min(bm, M - m0);
  for (int e = threadIdx.x; e < rows * gR; e += blockDim.x) {
    const int mm = e / gR;
    const int q = e - mm * gR;
    const int a = q / R;
    const int r = q - a * R;
    const float* xr = xg + (static_cast<long long>(m0 + mm) * g + a) * I;
    float acc = 0.f;
    for (int i = 0; i < I; ++i) acc = fmaf(xr[i], v[i * R + r], acc);
    t[e] = acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int mm = e / D;
    const int d = e - mm * D;
    const float* tr = t + mm * gR;
    float acc = 0.f;
    for (int q = 0; q < gR; ++q)
      acc = fmaf(tr[q], u2[static_cast<long long>(q) * D + d], acc);
    y[static_cast<long long>(m0 + mm) * D + d] = acc;
  }
}

extern "C" int rank_apply_f32(const void* xg, const void* v, const void* u2,
                              void* y, int M, int g, int I, int R, int D,
                              int bm, void* stream) {
  if (M == 0 || D == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(bm) * g * R * sizeof(float);
  cudaError_t err = allow_dynamic_smem(rank_apply_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (M + bm - 1) / bm;
  rank_apply_kernel<<<blocks, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xg), static_cast<const float*>(v),
      static_cast<const float*>(u2), static_cast<float*>(y), M, g, I, R, D,
      bm);
  return static_cast<int>(cudaGetLastError());
}
