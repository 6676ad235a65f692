// conv_rank: the fused conv rank path, basis conv (I -> R per input group)
// plus the coefficient contraction (g*R -> D), for a k x k SAME conv.
//
//   t[n, ho, wo, a*R + r] = sum_{ky, kx, i} xpad[n, ho*s + ky, wo*s + kx, a*I + i]
//                                          * basis[ky*k + kx, i, r]
//   y[n, ho, wo, d]       = sum_q t[n, ho, wo, q] * u2[q, d]
//   x (N, H, W, g*I) NHWC, basis (k*k, I, R), u2 (g*R, D) -> y (N, Ho, Wo, D)
//
// xpad is x under XLA's "SAME" padding: Ho = ceil(H / s), total padding
// max((Ho - 1) * s + k - H, 0), low side total // 2 (conv_rank.py
// _same_pads).  Padding is applied by bounds-masking the reads; no padded
// copy of x is made.
//
// Replaces: src/repro/kernels/conv_rank.py, conv_rank_pallas (body
// _conv_rank_kernel): one image per grid step, k*k shifted matmuls over
// the padded image in VMEM, the rank intermediate contracted in the same
// step.
//
// What bounds it here: the CNN's convs (16 images of 8x8x3 .. 4x4x24,
// R=8, D<=24) move well under 200 KB and do under 3 MFLOP per call, so
// a call is bound by launch latency, then by the bytes of x and y.
//
// Design: one block per (image, tile of th output rows x all Wo columns).
// The block stages the input window those rows need (zero outside the
// image) and the whole basis in shared memory, computes its rank tile
// (th*Wo pixels x g*R) into shared memory, then contracts it with u2 and
// writes (th*Wo, D) outputs.  t never reaches device memory.  f32 FFMA
// accumulation, no TF32.
#include "common.cuh"

__global__ void conv_rank_kernel(const float* __restrict__ x,
                                 const float* __restrict__ basis,
                                 const float* __restrict__ u2,
                                 float* __restrict__ y, int H, int W, int g,
                                 int I, int R, int D, int k, int stride,
                                 int Ho, int Wo, int pad_h, int pad_w,
                                 int th) {
  extern __shared__ float smem[];
  const int C = g * I;
  const int gR = g * R;
  const int ksq = k * k;
  const int WR = (th - 1) * stride + k;  // window rows
  const int WC = (Wo - 1) * stride + k;  // window columns
  float* win = smem;                     // (WR, WC, C)
  float* bs = win + WR * WC * C;         // (ksq, I, R)
  float* t = bs + ksq * I * R;           // (th * Wo, g * R)

  const int n = blockIdx.x;
  const int ho0 = blockIdx.y * th;
  const float* xn = x + static_cast<long long>(n) * H * W * C;
  const int h_base = ho0 * stride - pad_h;
  for (int e = threadIdx.x; e < WR * WC * C; e += blockDim.x) {
    const int ch = e % C;
    const int pix = e / C;
    const int wc = pix % WC;
    const int wr = pix / WC;
    const int hi = h_base + wr;
    const int wi = wc - pad_w;
    win[e] = (hi >= 0 && hi < H && wi >= 0 && wi < W)
                 ? xn[(static_cast<long long>(hi) * W + wi) * C + ch]
                 : 0.f;
  }
  for (int e = threadIdx.x; e < ksq * I * R; e += blockDim.x) bs[e] = basis[e];
  __syncthreads();

  const int rows = min(th, Ho - ho0);
  const int npix = rows * Wo;
  for (int e = threadIdx.x; e < npix * gR; e += blockDim.x) {
    const int q = e % gR;
    const int pix = e / gR;
    const int a = q / R;
    const int r = q - a * R;
    const int tr = pix / Wo;
    const int wo = pix - tr * Wo;
    float acc = 0.f;
    for (int ky = 0; ky < k; ++ky) {
      for (int kx = 0; kx < k; ++kx) {
        const float* xw =
            win + ((tr * stride + ky) * WC + (wo * stride + kx)) * C + a * I;
        const float* bw = bs + (ky * k + kx) * I * R + r;
        for (int i = 0; i < I; ++i) acc = fmaf(xw[i], bw[i * R], acc);
      }
    }
    t[e] = acc;
  }
  __syncthreads();

  float* yn = y + (static_cast<long long>(n) * Ho + ho0) * Wo * D;
  for (int e = threadIdx.x; e < npix * D; e += blockDim.x) {
    const int d = e % D;
    const int pix = e / D;
    const float* tp = t + pix * gR;
    float acc = 0.f;
    for (int q = 0; q < gR; ++q)
      acc = fmaf(tp[q], u2[static_cast<long long>(q) * D + d], acc);
    yn[static_cast<long long>(pix) * D + d] = acc;
  }
}

extern "C" int conv_rank_f32(const void* x, const void* basis, const void* u2,
                             void* y, int N, int H, int W, int g, int I,
                             int R, int D, int k, int stride, int Ho, int Wo,
                             int pad_h, int pad_w, int th, void* stream) {
  if (N == 0 || Ho == 0 || Wo == 0 || D == 0)
    return static_cast<int>(cudaSuccess);
  const int WR = (th - 1) * stride + k;
  const int WC = (Wo - 1) * stride + k;
  const size_t smem = (static_cast<size_t>(WR) * WC * g * I +
                       static_cast<size_t>(k) * k * I * R +
                       static_cast<size_t>(th) * Wo * g * R) * sizeof(float);
  cudaError_t err = allow_dynamic_smem(conv_rank_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N, (Ho + th - 1) / th);
  conv_rank_kernel<<<grid, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(basis),
      static_cast<const float*>(u2), static_cast<float*>(y), H, W, g, I, R, D,
      k, stride, Ho, Wo, pad_h, pad_w, th);
  return static_cast<int>(cudaGetLastError());
}
