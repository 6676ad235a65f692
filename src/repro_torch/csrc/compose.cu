// compose: the neural-composition product (paper Eq. 4, before the block
// reshape), with an optional leading client axis.
//
//   out[c, k, i, b*O + o] = sum_r basis[c, k, i, r] * coeff[c, b, r, o]
//   basis (C, ksq, I, R), coeff (C, m, R, O) -> out (C, ksq, I, m*O), f32
//
// Replaces: src/repro/kernels/compose.py, compose_pallas over
// _compose_pallas_3d / _compose_pallas_4d (bodies _compose_kernel and
// _compose_kernel_batched), one (bi x bj) MXU tile per grid step.
//
// What bounds it here: at the CNN's shapes (ksq=9, I<=8, R=8, m*O<=72) a
// call moves a few tens of KB and does under 0.1 MFLOP, so it is bound by
// launch latency and then by the output bytes it writes; the FLOPs are
// negligible against 67 TFLOP/s of f32 FFMA.
//
// Design: one thread per output element over a grid-stride loop, so the
// ragged edges need no host-side padding and every shape is one launch.
// Neighbouring threads write neighbouring output columns (coalesced
// stores); the basis row they share is a broadcast load and the
// coefficient column is read contiguously along o.  Accumulation is f32
// FFMA in the order r = 0..R-1 (no TF32), matching the f32 tolerance of
// the plain version.
#include "common.cuh"

__global__ void compose_kernel(const float* __restrict__ basis,
                               const float* __restrict__ coeff,
                               float* __restrict__ out, int ksqI, int R,
                               int m, int O, long long total) {
  const int MO = m * O;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
       idx < total; idx += step) {
    const long long row = idx / MO;  // flattened (c, k, i)
    const int j = static_cast<int>(idx - row * MO);
    const int b = j / O;
    const int o = j - b * O;
    const long long c = row / ksqI;
    const float* v = basis + row * R;
    const float* u = coeff + (c * m + b) * static_cast<long long>(R) * O + o;
    float acc = 0.f;
    for (int r = 0; r < R; ++r) acc = fmaf(v[r], u[static_cast<long long>(r) * O], acc);
    out[idx] = acc;
  }
}

extern "C" int compose_f32(const void* basis, const void* coeff, void* out,
                           int C, int ksq, int I, int R, int m, int O,
                           void* stream) {
  const long long total = static_cast<long long>(C) * ksq * I * m * O;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond that
  compose_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(basis), static_cast<const float*>(coeff),
      static_cast<float*>(out), ksq * I, R, m, O, total);
  return static_cast<int>(cudaGetLastError());
}
