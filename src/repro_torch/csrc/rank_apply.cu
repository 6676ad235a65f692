// rank_apply: the fused rank-space dense application y = (x . v) . u2.
//
//   t[m, a*R + r] = sum_i xg[m, a, i] * v[i, r]
//   y[m, d]       = sum_q t[m, q] * u2[q, d]
//   xg (M, g, I), v (I, R), u2 (g*R, D) -> y (M, D), f32; optionally t
//   (M, g, R) too, the residual of the rank-space backward; for each
//   client of a cohort, every operand with a leading client axis C, in
//   one launch (the unbatched call is C = 1)
//
// Replaces: src/repro/kernels/compose.py, rank_apply_pallas (body
// _rank_apply_kernel), which keeps the (bm, g*R) rank intermediate in
// VMEM between its two MXU matmuls.
//
// What bounds it here: latency.  The CNN's classifier head (M = 16,
// g = 3, I = 8, R = 8, D = 10) moves about 2.5 KB (bound 0.001 us) and
// does 10 kFLOP; the composed transformer's widest call (its MLP up
// projection at p = 3: M = 256, g = 3, I = 16, D = 96) moves 158 KB
// (bound 0.047 us) at ~2 FLOP a byte.  Far under the f32 FFMA ridge
// (20 FLOP a byte), so tensor cores are no lever (f32 accuracy on them
// would need a 3 x TF32 split), and the time is the launch, one round
// trip to device memory and the FMA chains.
//
// Design: the grid tiles rows (bm) and output columns (bd, a multiple of
// 4), chosen by the wrapper (compose.py _rank_apply_tiles) so that a call
// launches about 128 blocks where M allows, counted over the cohort's
// clients (grid z: one client, its operands offset by its strides);
// small M still spreads over several blocks.  A block stages its xg
// rows, all of v and its u2 column tile in shared memory with one round
// of cp.async copies (16 bytes where
// the rows are 16-byte multiples, 4 bytes otherwise, as for the head's
// D = 10), computes its rows' rank tile t (each thread four r at once,
// an I-long chain) into shared memory, then four outputs a thread (a
// float4 of u2's row, a g*R-long chain), the tail past D not stored.
// Blocks of the first column tile also write t when asked.  The rank tile
// otherwise never reaches device memory, as in the TPU kernel.  f32 FFMA,
// no TF32.  The path shapes (rank 8, 1-3 groups of 8, 16 or 32 inputs)
// run instances with the groups, inputs and r fixed at compile time
// (constant divisors, unrolled loops, x read as float4): at these short
// chains the index arithmetic costs as much as the FMAs.  Any other shape
// runs the generic instance.
#include "common.cuh"
#include "mma.cuh"

constexpr int RANK_APPLY_THREADS = 128;

// shared floats of one block: v (I, R4), u2 tile (g*R4, bd), xg rows
// (bm, g*I rounded to 4), the rank tile (bm, g*R4)
__host__ __device__ inline long long rank_apply_smem_floats(int g, int I,
                                                            int R, int bm,
                                                            int bd) {
  const long long R4 = round4(R);
  return I * R4 + g * R4 * bd + static_cast<long long>(bm) * round4(g * I) +
         static_cast<long long>(bm) * g * R4;
}

// G groups, II inputs a group and RQC quads of r fixed at compile time
// (0: the runtime value), so the path shapes get constant divisors,
// unrolled loops and float4 reads of x
template <int G, int II, int RQC>
__global__ void __launch_bounds__(RANK_APPLY_THREADS)
    rank_apply_kernel(const float* __restrict__ xg,
                      const float* __restrict__ v,
                      const float* __restrict__ u2, float* __restrict__ y,
                      float* __restrict__ t_out, int M, int g_, int I_,
                      int R, int D, int bm, int bd) {
  extern __shared__ float4 smem4[];
  const int g = G ? G : g_;
  const int I = II ? II : I_;
  // this block's client: its rows, basis, coefficients and outputs
  const long long client = blockIdx.z;
  xg += client * M * g * I;
  v += client * I * R;
  u2 += client * g * R * D;
  y += client * M * D;
  if (t_out != nullptr) t_out += client * M * g * R;
  const int R4 = RQC ? 4 * RQC : round4(R);
  const int gR4 = g * R4;
  const int gI4 = round4(g * I);
  float* vs = reinterpret_cast<float*>(smem4);  // (I, R4)
  float* us = vs + I * R4;                      // (g*R4, bd), row a*R4 + r
  float* xs = us + gR4 * bd;                    // (bm, gI4)
  float* ts = xs + bm * gI4;                    // (bm, g*R4)

  const int m0 = blockIdx.x * bm;
  const int d0 = blockIdx.y * bd;
  const int rows = min(bm, M - m0);
  const int cols = min(bd, D - d0);

  // ---- stage xg rows, v and the u2 column tile: one round trip --------
  stage_f32(xs, gI4, xg + static_cast<long long>(m0) * g * I, g * I, rows,
            g * I);
  stage_f32(vs, R4, v, R, I, R);
  for (int a = 0; a < g; ++a)
    stage_f32(us + a * R4 * bd, bd,
              u2 + static_cast<long long>(a) * R * D + d0, D, R, cols);
  for (int e = threadIdx.x; e < g * (R4 - R) * bd; e += blockDim.x) {
    const int a = e / ((R4 - R) * bd);
    us[a * R4 * bd + R * bd + (e - a * (R4 - R) * bd)] = 0.f;
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ---- stage 1: the rank tile, four r a thread --------------------------
  const int RQ = R4 / 4;
  const bool write_t = t_out != nullptr && blockIdx.y == 0;
  for (int it = threadIdx.x; it < rows * g * RQ; it += blockDim.x) {
    const int rq = it % RQ;
    const int ma = it / RQ;  // mm * g + a
    const float* xr = xs + (ma / g) * gI4 + (ma % g) * I;
    const float* vc = vs + rq * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (II % 4 == 0 && II > 0) {
#pragma unroll
      for (int i = 0; i < II; i += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + i);
        const float* b = vc + i * R4;
        fma4(acc, xv.x, *reinterpret_cast<const float4*>(b));
        fma4(acc, xv.y, *reinterpret_cast<const float4*>(b + R4));
        fma4(acc, xv.z, *reinterpret_cast<const float4*>(b + 2 * R4));
        fma4(acc, xv.w, *reinterpret_cast<const float4*>(b + 3 * R4));
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < I; ++i)
        fma4(acc, xr[i], *reinterpret_cast<const float4*>(vc + i * R4));
    }
    *reinterpret_cast<float4*>(ts + ma * R4 + rq * 4) = acc;
    if (write_t)
      store4(t_out + (static_cast<long long>(m0) * g + ma) * R + rq * 4, acc,
             R - rq * 4);
  }
  __syncthreads();

  // ---- stage 2: four outputs a thread -----------------------------------
  const int DQ = bd / 4;
  for (int it = threadIdx.x; it < rows * DQ; it += blockDim.x) {
    const int dq = it % DQ;
    const int mm = it / DQ;
    if (dq * 4 >= cols) continue;
    const float* tr = ts + mm * gR4;
    const float* uc = us + dq * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int q = 0; q < gR4; ++q)
      fma4(acc, tr[q], *reinterpret_cast<const float4*>(uc + q * bd));
    store4(y + static_cast<long long>(m0 + mm) * D + d0 + dq * 4, acc,
           cols - dq * 4);
  }
}

template <int G, int II, int RQC>
static int launch_rank_apply(const void* xg, const void* v, const void* u2,
                             void* y, void* t_out, int C, int M, int g, int I,
                             int R, int D, int bm, int bd,
                             cudaStream_t stream) {
  const size_t smem = rank_apply_smem_floats(g, I, R, bm, bd) * sizeof(float);
  cudaError_t err = allow_dynamic_smem(rank_apply_kernel<G, II, RQC>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + bm - 1) / bm, (D + bd - 1) / bd, C);
  rank_apply_kernel<G, II, RQC><<<grid, RANK_APPLY_THREADS, smem, stream>>>(
      static_cast<const float*>(xg), static_cast<const float*>(v),
      static_cast<const float*>(u2), static_cast<float*>(y),
      static_cast<float*>(t_out), M, g, I, R, D, bm, bd);
  return static_cast<int>(cudaGetLastError());
}

// Instances by shape: rank 8 with 1-3 groups of 8 (the CNN's head), 16 or
// 32 inputs (the composed transformer's layers); every other shape
// generic.
extern "C" int rank_apply_f32(const void* xg, const void* v, const void* u2,
                              void* y, void* t_out, int C, int M, int g,
                              int I, int R, int D, int bm, int bd,
                              void* stream) {
  if (C == 0 || M == 0 || D == 0) return static_cast<int>(cudaSuccess);
  if (C > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto go = launch_rank_apply<0, 0, 0>;
  if (R == 8 && g == 1 && I == 8) go = launch_rank_apply<1, 8, 2>;
  if (R == 8 && g == 2 && I == 8) go = launch_rank_apply<2, 8, 2>;
  if (R == 8 && g == 3 && I == 8) go = launch_rank_apply<3, 8, 2>;
  if (R == 8 && g == 1 && I == 16) go = launch_rank_apply<1, 16, 2>;
  if (R == 8 && g == 2 && I == 16) go = launch_rank_apply<2, 16, 2>;
  if (R == 8 && g == 3 && I == 16) go = launch_rank_apply<3, 16, 2>;
  if (R == 8 && g == 1 && I == 32) go = launch_rank_apply<1, 32, 2>;
  if (R == 8 && g == 2 && I == 32) go = launch_rank_apply<2, 32, 2>;
  if (R == 8 && g == 3 && I == 32) go = launch_rank_apply<3, 32, 2>;
  return go(xg, v, u2, y, t_out, C, M, g, I, R, D, bm, bd,
            static_cast<cudaStream_t>(stream));
}
