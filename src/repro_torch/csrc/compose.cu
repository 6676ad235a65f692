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
// What bounds it here: latency.  At the CNN's shapes (ksq = 9, I <= 8,
// R = 8, m*O <= 72) a call moves under 30 KB (bound under 0.01 us) and
// does under 0.1 MFLOP; the cohort stack of 10 clients moves ten times
// that.  So the time is the launch, the blocks' dispatch, one round trip
// to memory and an R-long FMA chain.  An empty kernel takes longer on
// more blocks, so a call should launch as few blocks as it needs.
//
// Design: the grid is client (z) x row tiles of the flattened (k, i) rows
// (x) x column tiles of the m*O output columns (y), one launch for the
// 3-d and the 4-d call.  A block is (cx, by) threads, 128 where the shape
// allows, chosen by the wrapper (compose.py _compose_tiles) so that a
// call launches as few blocks as fill it.  Thread (x, y) owns row y and
// four neighbouring columns, or one: block and thread indices give
// (client, row, column), and the column's coefficient block b = j / O is
// one multiply by a reciprocal the launcher computes.  Each thread reads
// its basis row and its R coefficient entries straight into registers
// (read-only loads, all in flight at once: one round trip), sums r =
// 0..R-1 in order, and writes its columns with one store.  Four columns
// a thread (float4 reads and stores) where O and R are multiples of 4
// and O < 32: a block row spans two quads, so a warp spans 16 rows and
// shares its coefficient quads.  One column a thread where O >= 32 (a
// warp reads a 128-byte line of a coefficient row), or where O or R rule
// out 16-byte accesses (the fc layer's O = 10).  Each read slower on the
// H100 at the timed shapes (PERF.md, PR 17): staging the tiles in shared
// memory with one cp.async round trip and a barrier, at every shape; a
// warp across 32 quads of one row, which reads the coefficient several
// times over, at conv2; 128 blocks or more, and four columns a thread at
// O = 32.  f32 FFMA, no TF32.  Rank 8 (every path's) runs an instance
// with r fixed at compile time; other ranks the generic one.
#include "common.cuh"

// VEC: a thread owns four columns (O and R multiples of 4, basis, coeff
// and out 16-byte aligned, so its columns lie in one block b and every
// access is a float4); otherwise one.  RQC quads of r fixed at compile
// time (0: the runtime R)
template <int RQC, bool VEC>
__global__ void compose_kernel(const float* __restrict__ basis,
                               const float* __restrict__ coeff,
                               float* __restrict__ out, int ksqI, int R_,
                               int m, int O, unsigned inv_O) {
  constexpr int CW = VEC ? 4 : 1;  // columns a thread owns
  const int R = RQC ? 4 * RQC : R_;
  const int MO = m * O;
  const int c = blockIdx.z;
  const int row = blockIdx.x * blockDim.y + threadIdx.y;  // (k, i) flattened
  const int j = CW * (blockIdx.y * blockDim.x + threadIdx.x);
  if (row >= ksqI || j >= MO) return;
  const float* vr = basis + (static_cast<long long>(c) * ksqI + row) * R;
  const int b = __umulhi(static_cast<unsigned>(j), inv_O);  // j / O
  const float* uc = coeff + (static_cast<long long>(c) * m + b) * R * O +
                    (j - b * O);
  float* dst = out + (static_cast<long long>(c) * ksqI + row) * MO + j;
  if constexpr (VEC) {
    const int O4 = O / 4;
    const float4* u4 = reinterpret_cast<const float4*>(uc);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (RQC > 0) {
      float4 vq[RQC], uq[4 * RQC];
#pragma unroll
      for (int q = 0; q < RQC; ++q)
        vq[q] = __ldg(reinterpret_cast<const float4*>(vr) + q);
#pragma unroll
      for (int r = 0; r < 4 * RQC; ++r) uq[r] = __ldg(u4 + r * O4);
#pragma unroll
      for (int q = 0; q < RQC; ++q) {
        fma4(acc, vq[q].x, uq[4 * q]);
        fma4(acc, vq[q].y, uq[4 * q + 1]);
        fma4(acc, vq[q].z, uq[4 * q + 2]);
        fma4(acc, vq[q].w, uq[4 * q + 3]);
      }
    } else {
#pragma unroll 4
      for (int r = 0; r < R; ++r) fma4(acc, __ldg(vr + r), __ldg(u4 + r * O4));
    }
    *reinterpret_cast<float4*>(dst) = acc;
  } else {
    float acc = 0.f;
#pragma unroll 8
    for (int r = 0; r < R; ++r)
      acc = fmaf(__ldg(vr + r), __ldg(uc + static_cast<long long>(r) * O),
                 acc);
    *dst = acc;
  }
}

template <int RQC, bool VEC>
static int launch_compose(const void* basis, const void* coeff, void* out,
                          int C, int ksqI, int R, int m, int O, int by,
                          int cx, unsigned inv_O, cudaStream_t stream) {
  const int cols = cx * (VEC ? 4 : 1);
  const dim3 block(cx, by);
  const dim3 grid((ksqI + by - 1) / by, (m * O + cols - 1) / cols, C);
  compose_kernel<RQC, VEC><<<grid, block, 0, stream>>>(
      static_cast<const float*>(basis), static_cast<const float*>(coeff),
      static_cast<float*>(out), ksqI, R, m, O, inv_O);
  return static_cast<int>(cudaGetLastError());
}

// cw: the columns a thread owns, 4 (the wrapper's choice where O and R
// are multiples of 4 and the operands 16-byte aligned) or 1
extern "C" int compose_f32(const void* basis, const void* coeff, void* out,
                           int C, int ksq, int I, int R, int m, int O,
                           int by, int cx, int cw, void* stream) {
  if (C == 0 || ksq * I == 0 || m * O == 0)
    return static_cast<int>(cudaSuccess);
  // b = j / O as umulhi(j, ceil(2^32 / O)) is exact while j * O < 2^32
  if (by < 1 || cx < 1 || by * cx > 1024 || (cw != 1 && cw != 4) ||
      static_cast<unsigned long long>(m) * O * O >= (1ull << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = cw == 4;
  if (vec && (O % 4 != 0 || R % 4 != 0 ||
              reinterpret_cast<uintptr_t>(basis) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(coeff) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const unsigned inv_O =
      static_cast<unsigned>(((1ull << 32) + O - 1) / static_cast<unsigned>(O));
  auto go = R == 8 ? launch_compose<2, false> : launch_compose<0, false>;
  if (vec) go = R == 8 ? launch_compose<2, true> : launch_compose<0, true>;
  return go(basis, coeff, out, C, ksq * I, R, m, O, by, cx, inv_O,
            static_cast<cudaStream_t>(stream));
}
