// conv_rank: the fused conv rank path, basis conv (I -> R per input group)
// plus the coefficient contraction (g*R -> D), for a k x k SAME conv.
//
//   t[n, ho, wo, a*R + r] = sum_{ky, kx, i} xpad[n, ho*s + ky, wo*s + kx, a*I + i]
//                                          * basis[ky*k + kx, i, r]
//   y[n, ho, wo, d]       = sum_q t[n, ho, wo, q] * u2[q, d]
//   x (N, H, W, g*I) NHWC, basis (k*k, I, R), u2 (g*R, D) -> y (N, Ho, Wo, D)
//   for each client c of a cohort: x (C, N, ...), basis (C, ...), u2
//   (C, ...) and y (C, N, ...), one launch (the unbatched call is C = 1)
//
// xpad is x under XLA's "SAME" padding: Ho = ceil(H / s), total padding
// max((Ho - 1) * s + k - H, 0), low side total // 2 (conv_rank.py
// _same_pads).  Padding is applied by zero-filling the out-of-image reads;
// no padded copy of x is made.
//
// Replaces: src/repro/kernels/conv_rank.py, conv_rank_pallas (body
// _conv_rank_kernel): one image per grid step, k*k shifted matmuls over
// the padded image in VMEM, the rank intermediate contracted in the same
// step.
//
// What bounds it here: latency.  The least time for the work at each
// timed shape (p = 3, batch 16; bytes over 3.35 TB/s, larger than FLOPs
// over 67 TFLOP/s f32 at each): conv2 square x (16,8,8,24) s = 2 ->
// (16,4,4,24) moves 128 KB, 0.038 us; conv1 grow_out x (16,8,8,3) ->
// (16,8,8,24) 112 KB, 0.034 us; on the cifar10 task's 32 x 32 images,
// conv1 1.77 MB, 0.53 us, and conv2 1.97 MB, 0.59 us.  The work is ~10
// FLOP a byte or less, under the f32 FFMA ridge of 67e12 / 3.35e12 = 20,
// and a call lasts a few microseconds: the launch, one round trip to
// device memory and the dependent FMA chains.  Tensor cores are not the
// lever: the work is far below the ridge, and f32 accuracy on them would
// need a 3 x TF32 split (three products for each one), so the kernel
// stays in f32 FFMA, no TF32.
//
// Design, for latency and parallelism (each choice measured against
// others on the card, PERF.md section 6):
// - Many small blocks: a block owns a th x tw rectangle of one image's
//   output pixels, chosen by the wrapper (conv_rank.py _conv_tiles) so
//   that a call launches about 128 blocks or more where the images allow
//   (128 at the timed conv2 shape), 256 threads each.  Each block
//   restages the basis and u2 (4.6 KB at p = 3) from L2.
// - A cohort is one grid: the C*N images of the clients line up along
//   blockIdx.x, and a block offsets the basis and u2 to its image's
//   client (c = image / N).  The tiles are sized over all C*N images, so
//   a 10-client cohort launches ~128 larger blocks, not ten times as
//   many tiny ones.
// - One round trip: the basis, u2 and the input window of the rectangle
//   (zero outside the image) go into shared memory together as cp.async
//   copies (16 bytes where C % 4 == 0 and the rows are aligned, 4 bytes
//   otherwise, as for conv1's C = 3), one wait, one barrier.  No device
//   memory is read after that.
// - Short chains: stage 1 splits the 3*3*I reduction by kernel row ky
//   (three partial rank tiles in shared memory), and each thread carries
//   four independent accumulators (four r, a float4 of the basis), so a
//   chain is 3*I = 24 FMAs long, not 72.  Stage 2 sums the partials as
//   it reads t and carries four outputs (a float4 of u2's row), g*R steps
//   long.  The rank tile never reaches device memory.  More work an item
//   (two pixels, eight r) read slower.
// - Instances by shape: at these short chains the index arithmetic and
//   loop overhead cost as much as the FMAs, so the CNN's convs (rank 8,
//   one group of 3 channels or 1-3 groups of 8, D 8/16/24) run instances
//   with the groups, channels, r and D fixed at compile time: constant
//   divisors, unrolled loops, x read as float4.  Any other shape runs the
//   generic instance, with the same code on runtime sizes.
// - R and D are padded to multiples of 4 in shared memory (zeros), so any
//   R and D run; outputs past D are not stored.
#include "common.cuh"
#include "mma.cuh"

constexpr int CONV_RANK_THREADS = 256;
constexpr int K = 3;  // taps a side: the launcher refuses any other k

// shared floats of one block: basis (K*K*I, R4), u2 (g*R4, D4), window
// (WR*WC*C, rounded to 4), K partial rank tiles (th*tw, g*R4)
__host__ __device__ inline long long conv_rank_smem_floats(
    int g, int I, int R, int D, int stride, int th, int tw) {
  const long long WR = (th - 1) * stride + K, WC = (tw - 1) * stride + K;
  return static_cast<long long>(K) * K * I * round4(R) +
         static_cast<long long>(g) * round4(R) * round4(D) +
         round4(static_cast<int>(WR * WC * g * I)) +
         static_cast<long long>(K) * th * tw * g * round4(R);
}

// G groups, II channels a group and RQC quads of r fixed at compile time
// (0: the runtime value), so the common CNN shapes get constant divisors,
// unrolled loops and float4 reads of x
template <int G, int II, int RQC, int DQC>
__global__ void __launch_bounds__(CONV_RANK_THREADS)
    conv_rank_kernel(const float* __restrict__ x,
                     const float* __restrict__ basis,
                     const float* __restrict__ u2, float* __restrict__ y,
                     int N, int H, int W, int g_, int I_, int R, int D,
                     int stride, int Ho, int Wo, int pad_h, int pad_w,
                     int th, int tw) {
  extern __shared__ float4 smem4[];
  const int g = G ? G : g_;
  const int I = II ? II : I_;
  const int C = g * I;
  const int R4 = RQC ? 4 * RQC : round4(R);
  const int D4 = DQC ? 4 * DQC : round4(D);
  const int gR4 = g * R4;
  const int WR = (th - 1) * stride + K;  // window rows
  const int WC = (tw - 1) * stride + K;  // window columns
  float* bs = reinterpret_cast<float*>(smem4);  // (K*K*I, R4)
  float* us = bs + K * K * I * R4;              // (g*R4, D4), row a*R4 + r
  float* win = us + gR4 * D4;                   // (WR, WC, C)
  float* tp = win + round4(WR * WC * C);        // (K, th*tw, g*R4)
  const int part = th * tw * gR4;               // floats of one partial

  // the block's rectangle of output pixels
  const int tiles_w = (Wo + tw - 1) / tw;
  const int tiles_h = (Ho + th - 1) / th;
  const int n = blockIdx.x / (tiles_w * tiles_h);  // image over the cohort
  const int tile = blockIdx.x - n * tiles_w * tiles_h;
  const int client = n / N;  // the image's client: its basis and u2
  basis += static_cast<long long>(client) * K * K * I * R;
  u2 += static_cast<long long>(client) * g * R * D;
  const int ho0 = (tile / tiles_w) * th;
  const int wo0 = (tile % tiles_w) * tw;
  const int rows = min(th, Ho - ho0);
  const int cols = min(tw, Wo - wo0);

  // ---- stage the basis, u2 and the input window: one round trip ------
  stage_f32(bs, R4, basis, R, K * K * I, R);
  for (int a = 0; a < g; ++a)
    stage_f32(us + a * R4 * D4, D4, u2 + static_cast<long long>(a) * R * D,
              D, R, D);
  for (int e = threadIdx.x; e < g * (R4 - R) * D4; e += blockDim.x) {
    const int a = e / ((R4 - R) * D4);
    us[a * R4 * D4 + R * D4 + (e - a * (R4 - R) * D4)] = 0.f;
  }
  const float* xn = x + static_cast<long long>(n) * H * W * C;
  const int h0 = ho0 * stride - pad_h;
  const int w0 = wo0 * stride - pad_w;
  const bool vec = C % 4 == 0 && aligned16(x);
  const int cw = vec ? 4 : 1;  // floats a copy
  for (int e = threadIdx.x; e < WR * WC * C / cw; e += blockDim.x) {
    const int pix = e / (C / cw);
    const int c = e * cw - pix * C;
    const int hi = h0 + pix / WC;
    const int wi = w0 + pix % WC;
    const bool in = hi >= 0 && hi < H && wi >= 0 && wi < W;
    const float* src =
        in ? xn + (static_cast<long long>(hi) * W + wi) * C + c : xn;
    if (vec)
      cp_async16(win + pix * C + c, src, in);
    else
      cp_async4(win + pix * C + c, src, in);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ---- stage 1: K partial rank tiles, one per kernel row ky ------------
  // item (ky, pixel, group a, four r): 4 accumulators over kx and i
  const int RQ = R4 / 4;
  const int npix = rows * cols;
  for (int it = threadIdx.x; it < K * npix * g * RQ; it += blockDim.x) {
    const int rq = it % RQ;
    int rest = it / RQ;
    const int a = rest % g;
    rest /= g;
    const int pix = rest % npix;
    const int ky = rest / npix;
    const int tr = pix / cols;
    const int tc = pix - tr * cols;
    const float* xw = win + ((tr * stride + ky) * WC + tc * stride) * C + a * I;
    const float* bw = bs + ky * K * I * R4 + rq * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int kx = 0; kx < K; ++kx) {
      if constexpr (II % 4 == 0 && II > 0) {
#pragma unroll
        for (int i = 0; i < II; i += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(xw + kx * C + i);
          const float* b = bw + (kx * II + i) * R4;
          fma4(acc, xv.x, *reinterpret_cast<const float4*>(b));
          fma4(acc, xv.y, *reinterpret_cast<const float4*>(b + R4));
          fma4(acc, xv.z, *reinterpret_cast<const float4*>(b + 2 * R4));
          fma4(acc, xv.w, *reinterpret_cast<const float4*>(b + 3 * R4));
        }
      } else {
#pragma unroll 4
        for (int i = 0; i < I; ++i)
          fma4(acc, xw[kx * C + i],
               *reinterpret_cast<const float4*>(bw + (kx * I + i) * R4));
      }
    }
    *reinterpret_cast<float4*>(tp + ky * part + pix * gR4 + a * R4 + rq * 4) =
        acc;
  }
  __syncthreads();

  // ---- stage 2: y = (sum of the partials) . u2, four d a thread --------
  const int DQ = D4 / 4;
  for (int it = threadIdx.x; it < npix * DQ; it += blockDim.x) {
    const int dq = it % DQ;
    const int pix = it / DQ;
    const float* t0 = tp + pix * gR4;
    const float* uc = us + dq * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int q = 0; q < gR4; ++q) {
      float tv = t0[q];
#pragma unroll
      for (int ky = 1; ky < K; ++ky) tv += t0[ky * part + q];
      fma4(acc, tv, *reinterpret_cast<const float4*>(uc + q * D4));
    }
    const int tr = pix / cols;
    const int tc = pix - tr * cols;
    float* yp = y + ((static_cast<long long>(n) * Ho + ho0 + tr) * Wo + wo0 +
                     tc) * D + dq * 4;
    store4(yp, acc, D - dq * 4);
  }
}

template <int G, int II, int RQC, int DQC>
static int launch_conv_rank(const void* x, const void* basis, const void* u2,
                            void* y, int C, int N, int H, int W, int g, int I,
                            int R, int D, int stride, int Ho, int Wo,
                            int pad_h, int pad_w, int th, int tw,
                            cudaStream_t stream) {
  const size_t smem =
      conv_rank_smem_floats(g, I, R, D, stride, th, tw) * sizeof(float);
  cudaError_t err =
      allow_dynamic_smem(conv_rank_kernel<G, II, RQC, DQC>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(C) * N *
                           ((Ho + th - 1) / th) * ((Wo + tw - 1) / tw);
  conv_rank_kernel<G, II, RQC, DQC>
      <<<static_cast<unsigned>(blocks), CONV_RANK_THREADS, smem, stream>>>(
          static_cast<const float*>(x), static_cast<const float*>(basis),
          static_cast<const float*>(u2), static_cast<float*>(y), N, H, W, g,
          I, R, D, stride, Ho, Wo, pad_h, pad_w, th, tw);
  return static_cast<int>(cudaGetLastError());
}

// Instances by shape: the CNN's convs at rank 8 (conv1: one group of 3
// channels; conv2/conv3: 1-3 groups of 8), every other shape generic.
extern "C" int conv_rank_f32(const void* x, const void* basis, const void* u2,
                             void* y, int C, int N, int H, int W, int g,
                             int I, int R, int D, int k, int stride, int Ho,
                             int Wo, int pad_h, int pad_w, int th, int tw,
                             void* stream) {
  if (k != K) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0 || N == 0 || Ho == 0 || Wo == 0 || D == 0)
    return static_cast<int>(cudaSuccess);
  auto go = launch_conv_rank<0, 0, 0, 0>;
  if (R == 8 && D == 8) {
    if (g == 1 && I == 3) go = launch_conv_rank<1, 3, 2, 2>;
    if (g == 1 && I == 8) go = launch_conv_rank<1, 8, 2, 2>;
    if (g == 2 && I == 8) go = launch_conv_rank<2, 8, 2, 2>;
    if (g == 3 && I == 8) go = launch_conv_rank<3, 8, 2, 2>;
  }
  if (R == 8 && D == 16) {
    if (g == 1 && I == 3) go = launch_conv_rank<1, 3, 2, 4>;
    if (g == 2 && I == 8) go = launch_conv_rank<2, 8, 2, 4>;
  }
  if (R == 8 && D == 24) {
    if (g == 1 && I == 3) go = launch_conv_rank<1, 3, 2, 6>;
    if (g == 3 && I == 8) go = launch_conv_rank<3, 8, 2, 6>;
  }
  return go(x, basis, u2, y, C, N, H, W, g, I, R, D, stride, Ho, Wo, pad_h,
            pad_w, th, tw, static_cast<cudaStream_t>(stream));
}
