// compose_apply: fused compose+apply for dense layers, y = x . (v . u).
//
//   W_a[i, d] = sum_r v[i, r] * u3[a, r, d]
//   y[m, d]   = sum_a sum_i xg[m, a, i] * W_a[i, d]
//   xg (M, g, I), v (I, R), u3 (g, R, D) -> y (M, D), f32; optionally t
//   (M, g, R) = xg . v too, the residual of the rank-space backward; for
//   each client of a cohort, every operand with a leading client axis C,
//   in one launch (the unbatched call is C = 1)
//
// Replaces: src/repro/kernels/compose.py, compose_apply_pallas (body
// _compose_apply_kernel), which builds each group's weight slice W_a in
// VMEM and contracts it with the matching input group in the same step.
//
// What bounds it here: latency.  The CNN's classifier head (M = 16,
// g = 3, I = 8, R = 8, D = 10), the one path shape, moves 3.4 KB (bound
// 0.001 us) and does 12 kFLOP: far under a microsecond of work, so the
// time is the launch, one round trip to device memory and two short FMA
// chains.
//
// Design (that of rank_apply.cu, with the TPU kernel's association): the
// grid tiles rows (bm <= 16) and output columns (bd <= 32, a multiple of
// 4), chosen by the wrapper (compose.py _compose_apply_tiles) so that a
// call launches about 128 blocks where M allows, counted over the
// cohort's clients (grid z: one client, its operands offset by its
// strides).  A block stages its xg rows, all of v and its u3 column tile
// in shared memory with one round of cp.async copies, builds its
// (g*I, bd) tile of the composed weight
// W = [W_0; ...; W_{g-1}] there (four columns an item, an R-long chain
// in r order), then each thread adds x . W into four outputs (one float4
// accumulator, a g*I-long chain), the tail past D not stored.  Where the
// weight tile does not fit beside the staged operands it is built in
// chunks of kc rows along g*I, the accumulators kept across chunks.
// Blocks of the first column tile also write t when asked.  The composed
// weight never reaches device memory, as in the TPU kernel.  f32 FFMA, no
// TF32.  The path shapes (rank 8, 1-3 groups of 8 inputs, one chunk)
// run instances with the groups, inputs and r fixed at compile
// time; any other shape runs the generic instance.
#include "common.cuh"
#include "mma.cuh"

constexpr int COMPOSE_APPLY_THREADS = 128;
// output column quads a block owns at most (bd <= 32): thread tid owns
// row tid / CA_QUADS and column quad tid % CA_QUADS, so bm <= 16
constexpr int CA_QUADS = 8;

// shared floats of one block: v (I, R4), the u3 column tile (g*R, bd),
// xg rows (bm, g*I rounded to 4), a weight chunk (kc, bd)
__host__ __device__ inline long long compose_apply_smem_floats(
    int g, int I, int R, int bm, int bd, int kc) {
  return static_cast<long long>(I) * round4(R) +
         static_cast<long long>(g) * R * bd +
         static_cast<long long>(bm) * round4(g * I) +
         static_cast<long long>(kc) * bd;
}

// G groups, II inputs a group and RQC quads of r fixed at compile time
// (0: the runtime value); a fixed instance builds its weight in one chunk
template <int G, int II, int RQC>
__global__ void __launch_bounds__(COMPOSE_APPLY_THREADS)
    compose_apply_kernel(const float* __restrict__ xg,
                         const float* __restrict__ v,
                         const float* __restrict__ u3, float* __restrict__ y,
                         float* __restrict__ t_out, int M, int g_, int I_,
                         int R_, int D, int bm, int bd, int kc_) {
  constexpr bool FIXED = G > 0 && II > 0 && RQC > 0;
  extern __shared__ float4 smem4[];
  const int g = G ? G : g_;
  const int I = II ? II : I_;
  const int R = RQC ? 4 * RQC : R_;
  const int R4 = round4(R);
  const int gI = g * I;
  const int gI4 = round4(gI);
  const int kc = FIXED ? G * II : kc_;
  // this block's client: its rows, basis, coefficients and outputs
  const long long client = blockIdx.z;
  xg += client * M * gI;
  v += client * I * R;
  u3 += client * g * R * D;
  y += client * M * D;
  if (t_out != nullptr) t_out += client * M * g * R;
  float* vs = reinterpret_cast<float*>(smem4);  // (I, R4)
  float* us = vs + I * R4;                      // (g*R, bd), row a*R + r
  float* xs = us + g * R * bd;                  // (bm, gI4)
  float* ws = xs + bm * gI4;                    // (kc, bd): rows k0.. of W

  const int m0 = blockIdx.x * bm;
  const int d0 = blockIdx.y * bd;
  const int rows = min(bm, M - m0);
  const int cols = min(bd, D - d0);
  const int DQ = (cols + 3) / 4;  // column quads with an output

  // ---- stage xg rows, v and the u3 column tile: one round trip --------
  stage_f32(xs, gI4, xg + static_cast<long long>(m0) * gI, gI, rows, gI);
  stage_f32(vs, R4, v, R, I, R);
  for (int a = 0; a < g; ++a)
    stage_f32(us + a * R * bd, bd, u3 + static_cast<long long>(a) * R * D + d0,
              D, R, cols);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ---- t = xg . v for the backward, four r a thread ---------------------
  if (t_out != nullptr && blockIdx.y == 0) {
    const int RQ = R4 / 4;
    for (int it = threadIdx.x; it < rows * g * RQ; it += blockDim.x) {
      const int rq = it % RQ;
      const int ma = it / RQ;  // mm * g + a
      const float* xr = xs + (ma / g) * gI4 + (ma % g) * I;
      const float* vc = vs + rq * 4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int i = 0; i < I; ++i)
        fma4(acc, xr[i], *reinterpret_cast<const float4*>(vc + i * R4));
      store4(t_out + (static_cast<long long>(m0) * g + ma) * R + rq * 4, acc,
             R - rq * 4);
    }
  }

  // ---- the weight tile, chunk by chunk, and x . W -----------------------
  const int mm = threadIdx.x / CA_QUADS;
  const int dq = threadIdx.x % CA_QUADS;
  const bool live = mm < rows && dq < DQ;
  const float* xr = xs + mm * gI4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < gI; k0 += kc) {
    const int kn = min(kc, gI - k0);
    if (k0 > 0) __syncthreads();  // the previous chunk is consumed
    // W[k, 4q..4q+3] = sum_r v[i, r] * u3[a, r, 4q..4q+3], k = a*I + i
    for (int it = threadIdx.x; it < kn * DQ; it += blockDim.x) {
      const int kk = it / DQ;
      const int q = it - kk * DQ;
      const int k = k0 + kk;
      const int a = k / I;
      const float* vr = vs + (k - a * I) * R4;
      const float* ur = us + a * R * bd + q * 4;
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int r = 0; r < R; ++r)
        fma4(w, vr[r], *reinterpret_cast<const float4*>(ur + r * bd));
      *reinterpret_cast<float4*>(ws + kk * bd + q * 4) = w;
    }
    __syncthreads();
    if (!live) continue;
    const float* wc = ws + dq * 4;
    if constexpr (FIXED && (G * II) % 4 == 0) {
#pragma unroll
      for (int k = 0; k < G * II; k += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + k);
        const float* w = wc + k * bd;
        fma4(acc, xv.x, *reinterpret_cast<const float4*>(w));
        fma4(acc, xv.y, *reinterpret_cast<const float4*>(w + bd));
        fma4(acc, xv.z, *reinterpret_cast<const float4*>(w + 2 * bd));
        fma4(acc, xv.w, *reinterpret_cast<const float4*>(w + 3 * bd));
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk)
        fma4(acc, xr[k0 + kk], *reinterpret_cast<const float4*>(wc + kk * bd));
    }
  }
  if (live)
    store4(y + static_cast<long long>(m0 + mm) * D + d0 + dq * 4, acc,
           cols - dq * 4);
}

template <int G, int II, int RQC>
static int launch_compose_apply(const void* xg, const void* v, const void* u3,
                                void* y, void* t_out, int C, int M, int g,
                                int I, int R, int D, int bm, int bd, int kc,
                                cudaStream_t stream) {
  const size_t smem =
      compose_apply_smem_floats(g, I, R, bm, bd, kc) * sizeof(float);
  cudaError_t err = allow_dynamic_smem(compose_apply_kernel<G, II, RQC>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + bm - 1) / bm, (D + bd - 1) / bd, C);
  compose_apply_kernel<G, II, RQC>
      <<<grid, COMPOSE_APPLY_THREADS, smem, stream>>>(
          static_cast<const float*>(xg), static_cast<const float*>(v),
          static_cast<const float*>(u3), static_cast<float*>(y),
          static_cast<float*>(t_out), M, g, I, R, D, bm, bd, kc);
  return static_cast<int>(cudaGetLastError());
}

// Instances by shape: rank 8 with 1-3 groups of 8 inputs (the CNN's head
// and the calibration's), the weight in one chunk; every other shape
// generic.
extern "C" int compose_apply_f32(const void* xg, const void* v,
                                 const void* u3, void* y, void* t_out, int C,
                                 int M, int g, int I, int R, int D, int bm,
                                 int bd, int kc, void* stream) {
  if (C == 0 || M == 0 || D == 0) return static_cast<int>(cudaSuccess);
  if (C > 65535 || bm < 1 || bm * CA_QUADS > COMPOSE_APPLY_THREADS ||
      bd % 4 != 0 || bd > 4 * CA_QUADS || kc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto go = launch_compose_apply<0, 0, 0>;
  if (R == 8 && kc == g * I) {
    if (g == 1 && I == 8) go = launch_compose_apply<1, 8, 2>;
    if (g == 2 && I == 8) go = launch_compose_apply<2, 8, 2>;
    if (g == 3 && I == 8) go = launch_compose_apply<3, 8, 2>;
  }
  return go(xg, v, u3, y, t_out, C, M, g, I, R, D, bm, bd, kc,
            static_cast<cudaStream_t>(stream));
}
