// flash_attention_bwd: the gradient of flash attention
// (csrc/flash_attention.cu) for bf16 tensors, from the forward's output
// and its row log-sum-exp.
//
//   P[b, i, j]  = exp(s[b, i, j] - lse[b, i])  (s the forward's masked
//                                                scores: a masked pair 0)
//   delta[b, i] = sum_d dout[b, i, d] out[b, i, d]
//   dS[b, i, j] = P[b, i, j] (dout[b, i] . v[b / G, j] - delta[b, i])
//   dq[b, i] = D^-0.5 sum_j dS[b, i, j] k[b / G, j]
//   dk[c, j] = D^-0.5 sum_{b / G = c} sum_i dS[b, i, j] q[b, i]
//   dv[c, j] = sum_{b / G = c} sum_i P[b, i, j] dout[b, i]
//   q, out, dout (BH, Sq, D), k/v (BKV, Sk, D) bf16; lse (BH, Sq) f32 in
//   natural log (the forward's); kv_len (BKV,) int32 or null; delta (BH,
//   Sq) f32 scratch, written by the first kernel and read by the second
//   -> dq (BH, Sq, D), dk/dv (BKV, Sk, D) bf16, BH = BKV * G; the masks
//   are the forward's (causal, window, kv_len, queries aligned to the end
//   of the keys), a key no query sees gets zero dk and dv, and a query
//   that sees no key (lse about -1e30: the forward wrote it zeros) gets
//   zero dq and gives no dk or dv
//
// Replaces no TPU kernel: the reference's flash_attention_pallas is
// forward only, and its training path differentiates plain JAX.  The
// port first carried that over as a replay of the plain version in f32
// under autograd (whole score matrices, CUDA-core f32 GEMMs and a dozen
// elementwise kernels a layer), which took 84 % of a StableLM-3B
// training step on the H100; this pair takes its place for bf16 tensors
// on the card (kernels/ops.py::_FlashAttention).
//
// What bounds it here: operations.  The exact softmax gradient needs five
// products of the head size per attended pair (S and dP recomputed, dV,
// dK and dQ: 10 D FLOPs) against bytes linear in the sequence (at the
// stablelm_3b train_4k shape, ~430 GFLOP against ~170 MB: ~0.43 ms at the
// bf16 tensor-core peak).
//
// Design: two kernels on the stream, and no block adds into another's
// output, so the gradients are deterministic (bitwise the same for the
// same inputs).  Both run every product on the tensor cores
// (mma.sync.m16n8k16, bf16 operands read from shared memory by ldmatrix,
// .trans where a product needs the transposed tile, f32 accumulators),
// stream their tiles through a 2-stage ring of 16-byte cp.async copies
// while the previous tile computes, and hold S, P, dP and dS in f32
// registers; P and dS are rounded to bf16 (to nearest even, as the
// forward rounds P before P.V) only as A operands, straight from the
// accumulators.
//   flash_bwd_dq_kernel: one block per (row b, tile of 16 W queries), W
//   warps of 16 query rows (W = 4 up to D = 80, else 8; FlashBwdShape
//   sizes every tile per D).  It computes delta for its rows from its own
//   dO tile and the output (f32 sums, written to the scratch), then walks
//   the key tiles the mask allows: S = Q K^T and dP = dO V^T, P = 2^(S
//   scale log2 e - lse log2 e), dS = P (dP - delta), dQ += dS K.
//   flash_bwd_dkdv_kernel: one block per (KV row, tile of keys), W warps
//   of 16 key rows (above D = 128 two warps share 16 keys, each
//   accumulating half of dK's and dV's columns, for registers).  It walks
//   the KV row's q_per_kv query heads and, in each, the query tiles the
//   mask allows (Q, dO, lse and delta through the ring): S^T = K Q^T and
//   dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q in registers, so GQA
//   sums there, with no atomics.
// dQ and dK/dV from separate passes recompute S and dP twice: 14 D FLOPs
// a pair instead of 10 D, the price of determinism.  As in the forward,
// the head dim is zero-padded to a multiple of 16 in shared memory and
// instantiated per count of 16-wide chunks (every D up to 256), a masked
// score is -1e30, only tiles that cross a mask edge evaluate the mask, and
// tiles masked for every pair are skipped.  The scale D^-0.5 multiplies
// the scores in the exponent and dq and dk once at the end, where the
// plain version applies it.
#include "common.cuh"
#include "mma.cuh"

#include <cuda_bf16.h>
#include <math.h>

#define FB_MAX_D 256
#define FB_NEG -1e30f
// a row's lse at or below this saw no key in the forward (which wrote it
// zeros): its P, and with it every gradient it gives, is 0
#define FB_NO_KEY -1e29f
#define FB_LOG2E 1.4426950408889634f
#define FB_SMALL_NDC 5  // up to D = 80: 4 warps a block, 64-query tiles

typedef __nv_bfloat16 fb_bf16;

// Tiles per count of 16-wide chunks, for registers (255 a thread, none
// spilled) and shared memory.  Up to D = 80 a block has 4 warps and the
// dk/dv pass takes 64 queries a tile: timed at train_4k x stablelm_3b on the
// H100, the pair took 2.50 ms against 2.93 with 8 warps and 32 queries.
// Wider heads keep 8 warps and 32 queries: 64 would not fit the registers.
template <int NDC>
struct FlashBwdShape {
  static constexpr int DP = 16 * NDC;  // padded head dim
  static constexpr int LD = DP + 8;    // smem row stride: no bank conflicts
                                       // for ldmatrix
  static constexpr int WARPS = NDC <= FB_SMALL_NDC ? 4 : 8;
  static constexpr int NTHR = 32 * WARPS;
  // dq pass: 16 query rows a warp, keys in tiles of BN
  static constexpr int BQ = 16 * WARPS;
  static constexpr int BN = NDC <= 8 ? 64 : 32;
  static constexpr bool Q_IN_REGS = NDC <= 6;
  static constexpr size_t DQ_SMEM =
      static_cast<size_t>(2 * BQ + 4 * BN) * LD * sizeof(fb_bf16) +
      BQ * sizeof(float);
  // dk/dv pass: CS warps share 16 key rows, each accumulating NDW of the
  // NDC column chunks; queries in tiles of BM
  static constexpr int CS = NDC <= 8 ? 1 : 2;
  static constexpr int NDW = NDC / CS;
  static constexpr int BK = 16 * WARPS / CS;
  static constexpr int BM = NDC <= FB_SMALL_NDC ? 64 : 32;
  static constexpr bool KV_IN_REGS = NDC <= 6;
  static constexpr size_t DKDV_SMEM =
      static_cast<size_t>(2 * BK + 4 * BM) * LD * sizeof(fb_bf16) +
      4 * BM * sizeof(float);
  static_assert(NDC % CS == 0, "column chunks split evenly");
  static_assert(2 * BQ == NTHR, "two threads a row for delta");
  static_assert(2 * BM <= NTHR, "one thread a value of lse and delta");
};

// columns c and c + 1 of a bf16 row, each rounded once from f32
__device__ __forceinline__ void store_pair(fb_bf16* row, int c, int D,
                                           float x0, float x1, int vec) {
  if (vec) {  // D is a multiple of 8: the pair is in range
    if (c < D)
      *reinterpret_cast<__nv_bfloat162*>(row + c) =
          __floats2bfloat162_rn(x0, x1);
  } else {
    if (c < D) row[c] = __float2bfloat16(x0);
    if (c + 1 < D) row[c + 1] = __float2bfloat16(x1);
  }
}

// the four A-operand registers of a 16-deep product from the f32
// accumulators of two adjacent 8-column tiles, rounded to bf16
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&x)[4],
                                       const float (&y)[4]) {
  a[0] = pack_bf16(x[0], x[1]);
  a[1] = pack_bf16(x[2], x[3]);
  a[2] = pack_bf16(y[0], y[1]);
  a[3] = pack_bf16(y[2], y[3]);
}

// ---------------------------------------------------------------------------
// dQ (and delta): one block per (row b, tile of BQ queries)
// ---------------------------------------------------------------------------

template <int NDC>
__global__ void __launch_bounds__(FlashBwdShape<NDC>::NTHR, 1)
flash_bwd_dq_kernel(const fb_bf16* __restrict__ q,
                    const fb_bf16* __restrict__ k,
                    const fb_bf16* __restrict__ v,
                    const fb_bf16* __restrict__ out,
                    const fb_bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    fb_bf16* __restrict__ dq, const int* __restrict__ kv_len,
                    int Sq, int Sk, int D, int q_per_kv, int causal,
                    int window, float scale_log2, float scale, int vec) {
  using Sh = FlashBwdShape<NDC>;
  constexpr int LD = Sh::LD, BN = Sh::BN, NT = BN / 8, BQ = Sh::BQ;
  constexpr int QR = Sh::Q_IN_REGS ? 1 : 0;
  extern __shared__ __align__(16) unsigned char fb_smem[];
  fb_bf16* Qs = reinterpret_cast<fb_bf16*>(fb_smem);
  fb_bf16* dOs = Qs + BQ * LD;
  fb_bf16* Ks = dOs + BQ * LD;  // 2 stages of BN rows
  fb_bf16* Vs = Ks + 2 * BN * LD;
  float* Ds = reinterpret_cast<float*>(Vs + 2 * BN * LD);  // the rows' delta

  const int nq = (Sq + BQ - 1) / BQ;
  const int b = blockIdx.x;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q_offset = Sk - Sq;
  const long long row_off = static_cast<long long>(b) * Sq;
  const long long kv_off = static_cast<long long>(b / q_per_kv) * Sk * D;
  const fb_bf16* kb = k + kv_off;
  const fb_bf16* vb = v + kv_off;
  // the keys this row has: its count, at most Sk
  const int nk = kv_len ? max(0, min(Sk, kv_len[b / q_per_kv])) : Sk;

  // key range any query of this tile can see
  const int q_first = q0 + q_offset;
  const int q_last = min(q0 + BQ, Sq) - 1 + q_offset;
  int kv_lo = 0, kv_hi = nk;
  if (causal) kv_hi = min(nk, q_last + 1);
  if (window > 0) kv_lo = max(0, q_first - window + 1);
  const int t_begin = kv_lo / BN;
  const int t_end = kv_hi > kv_lo ? (kv_hi + BN - 1) / BN : t_begin;

  const long long q_at = (row_off + q0) * D;
  stage_rows<fb_bf16, Sh::DP>(Qs, LD, q + q_at, D, Sq - q0, BQ, D, vec, tid,
                              Sh::NTHR);
  stage_rows<fb_bf16, Sh::DP>(dOs, LD, dout + q_at, D, Sq - q0, BQ, D, vec,
                              tid, Sh::NTHR);
  cp_async_commit();
  auto stage_kv = [&](int t, int st) {
    const int k0 = t * BN;
    const long long off = static_cast<long long>(k0) * D;
    stage_rows<fb_bf16, Sh::DP>(Ks + st * BN * LD, LD, kb + off, D, nk - k0,
                                BN, D, vec, tid, Sh::NTHR);
    stage_rows<fb_bf16, Sh::DP>(Vs + st * BN * LD, LD, vb + off, D, nk - k0,
                                BN, D, vec, tid, Sh::NTHR);
  };
  if (t_begin < t_end) stage_kv(t_begin, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q and dO are in
  __syncthreads();

  // delta = dO . O in f32, two threads a row (even and odd columns), the
  // two halves added by one shuffle: one fixed order
  {
    const int r = tid >> 1, half = tid & 1;
    const int row = q0 + r;
    float acc = 0.f;
    if (row < Sq) {
      const fb_bf16* orow = out + (row_off + row) * D;
      const fb_bf16* drow = dOs + r * LD;
      for (int d = half; d < D; d += 2)
        acc = fmaf(__bfloat162float(drow[d]), __bfloat162float(orow[d]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      Ds[r] = acc;
      if (row < Sq) delta[row_off + row] = acc;
    }
  }
  __syncthreads();

  // this warp's rows: row0 + g (h = 0) and row0 + g + 8 (h = 1); a row
  // past Sq has zero Q and dO, lse 0 and delta 0, so its dS is 0; a row
  // that saw no key takes P = 0 (has[h] false)
  const int row0 = 16 * warp;
  float lse2[2], dl[2];
  bool has[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    const float lr = q0 + r < Sq ? lse[row_off + q0 + r] : 0.f;
    has[h] = lr > FB_NO_KEY;
    lse2[h] = lr * FB_LOG2E;
    dl[h] = Ds[r];
  }

  // ldmatrix lane offsets as in the forward: A (rows i % 16, cols 8 (i /
  // 16)); B from a row-major tile (rows i % 8 + 8 (i / 16), cols 8 ((i /
  // 8) % 2)); B from a row-major tile, transposed (rows i % 8 + 8 ((i / 8)
  // % 2), cols 8 (i / 16))
  const fb_bf16* qa = Qs + (row0 + (lane & 15)) * LD + 8 * (lane >> 4);
  const fb_bf16* da = dOs + (row0 + (lane & 15)) * LD + 8 * (lane >> 4);
  const int b_ld = ((lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1);
  const int t_ld = ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
  uint32_t qf[QR ? NDC : 1][4], df[QR ? NDC : 1][4];
  if (QR) {
#pragma unroll
    for (int kc = 0; kc < (QR ? NDC : 1); ++kc) {
      ldmatrix_x4(qf[kc], qa + 16 * kc);
      ldmatrix_x4(df[kc], da + 16 * kc);
    }
  }

  float acc[2 * NDC][4];
#pragma unroll
  for (int i = 0; i < 2 * NDC; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    if (t + 1 < t_end) stage_kv(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const fb_bf16* Kt = Ks + st * BN * LD;
    const fb_bf16* Vt = Vs + st * BN * LD;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows and BN keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NDC; ++kc) {
      uint32_t a[4], ad[4];
      if (QR) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[j] = qf[QR ? kc : 0][j];
          ad[j] = df[QR ? kc : 0][j];
        }
      } else {
        ldmatrix_x4(a, qa + 16 * kc);
        ldmatrix_x4(ad, da + 16 * kc);
      }
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, Kt + 16 * n2 * LD + b_ld + 16 * kc);
        ldmatrix_x4(bv, Vt + 16 * n2 * LD + b_ld + 16 * kc);
        mma_bf16(s[2 * n2], a, bk[0], bk[1]);
        mma_bf16(s[2 * n2 + 1], a, bk[2], bk[3]);
        mma_bf16(dp[2 * n2], ad, bv[0], bv[1]);
        mma_bf16(dp[2 * n2 + 1], ad, bv[2], bv[3]);
      }
    }

    // P from the forward's lse (log2 domain), then dS = P (dP - delta),
    // kept in s; only tiles that cross a mask edge evaluate the mask
    const int k0 = t * BN;
    const bool edge = k0 + BN > nk || (causal && k0 + BN - 1 > q0 + q_offset) ||
                      (window > 0 && k0 < q_last - window + 1);
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale_log2;
        if (edge) {
          const int kpos = k0 + 8 * i + 2 * tq + (j & 1);
          const int qpos = q0 + row0 + g + 8 * (j >> 1) + q_offset;
          bool ok = kpos < nk;
          if (causal) ok = ok && qpos >= kpos;
          if (window > 0) ok = ok && (qpos - kpos) < window;
          x = ok ? x : FB_NEG;
        }
        // P <= 1: the clamp only keeps rounding from passing it
        const float p = has[j >> 1]
                            ? fast_exp2(fminf(x - lse2[j >> 1], 0.f)) : 0.f;
        s[i][j] = p * (dp[i][j] - dl[j >> 1]);
      }

    // dQ += dS K: dS rounded to bf16 as the A operand, K read transposed
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t a[4];
      pack_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int d2 = 0; d2 < NDC; ++d2) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, Kt + 16 * kc * LD + t_ld + 16 * d2);
        mma_bf16(acc[2 * d2], a, bk[0], bk[1]);
        mma_bf16(acc[2 * d2 + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + row0 + g + 8 * h;
    if (row >= Sq) continue;
    fb_bf16* drow = dq + (row_off + row) * D;
#pragma unroll
    for (int i = 0; i < 2 * NDC; ++i)
      store_pair(drow, 8 * i + 2 * tq, D, acc[i][2 * h] * scale,
                 acc[i][2 * h + 1] * scale, vec);
  }
}

// ---------------------------------------------------------------------------
// dK and dV: one block per (KV row, tile of BK keys)
// ---------------------------------------------------------------------------

template <int NDC>
__global__ void __launch_bounds__(FlashBwdShape<NDC>::NTHR, 1)
flash_bwd_dkdv_kernel(const fb_bf16* __restrict__ q,
                      const fb_bf16* __restrict__ k,
                      const fb_bf16* __restrict__ v,
                      const fb_bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      fb_bf16* __restrict__ dk, fb_bf16* __restrict__ dv,
                      const int* __restrict__ kv_len, int Sq, int Sk, int D,
                      int q_per_kv, int causal, int window, float scale_log2,
                      float scale, int vec) {
  using Sh = FlashBwdShape<NDC>;
  constexpr int LD = Sh::LD, BK = Sh::BK, BM = Sh::BM, NT = BM / 8;
  constexpr int NDW = Sh::NDW, CS = Sh::CS;
  constexpr int KR = Sh::KV_IN_REGS ? 1 : 0;
  extern __shared__ __align__(16) unsigned char fb_smem[];
  fb_bf16* Ks = reinterpret_cast<fb_bf16*>(fb_smem);
  fb_bf16* Vs = Ks + BK * LD;
  fb_bf16* Qs = Vs + BK * LD;     // 2 stages of BM rows
  fb_bf16* dOs = Qs + 2 * BM * LD;
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BM * LD);  // 2 stages
  float* Dl = Ls + 2 * BM;

  const int c = blockIdx.x;  // the KV row
  const int k0 = blockIdx.y * BK;  // the longest causal tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q_offset = Sk - Sq;
  const long long kv_off = static_cast<long long>(c) * Sk * D;
  const int nk = kv_len ? max(0, min(Sk, kv_len[c])) : Sk;

  // the queries that see some key of this tile: none past the row's keys
  int q_lo = 0, q_hi = 0;
  if (k0 < nk) {
    const int k1 = min(k0 + BK, nk);
    q_lo = causal ? max(0, k0 - q_offset) : 0;
    q_hi = window > 0 ? min(Sq, k1 - 1 + window - q_offset) : Sq;
  }
  const int t_begin = q_lo / BM;
  const int ntile = q_hi > q_lo ? (q_hi + BM - 1) / BM - t_begin : 0;
  const int n_it = ntile * q_per_kv;  // (query head, query tile) pairs

  if (n_it > 0) {
    const long long at = kv_off + static_cast<long long>(k0) * D;
    stage_rows<fb_bf16, Sh::DP>(Ks, LD, k + at, D, nk - k0, BK, D, vec, tid,
                                Sh::NTHR);
    stage_rows<fb_bf16, Sh::DP>(Vs, LD, v + at, D, nk - k0, BK, D, vec, tid,
                                Sh::NTHR);
  }
  cp_async_commit();
  auto stage_q = [&](int it, int st) {
    const int bh = c * q_per_kv + it / ntile;
    const int qt0 = (t_begin + it % ntile) * BM;
    const long long ro = static_cast<long long>(bh) * Sq + qt0;
    stage_rows<fb_bf16, Sh::DP>(Qs + st * BM * LD, LD, q + ro * D, D,
                                Sq - qt0, BM, D, vec, tid, Sh::NTHR);
    stage_rows<fb_bf16, Sh::DP>(dOs + st * BM * LD, LD, dout + ro * D, D,
                                Sq - qt0, BM, D, vec, tid, Sh::NTHR);
    // a row past Sq reads lse 0 and delta 0 (its Q and dO are zeros)
    if (tid < 2 * BM) {
      const int e = tid % BM;
      const bool ok = qt0 + e < Sq;
      const float* src = tid < BM ? lse : delta;
      float* dst = (tid < BM ? Ls : Dl) + st * BM + e;
      cp_async4(dst, src + (ok ? ro + e : ro), ok);
    }
  };
  if (n_it > 0) stage_q(0, 0);
  cp_async_commit();

  // this warp's key rows kr0 + g (h = 0) and + 8 (h = 1), and its column
  // chunks cw .. cw + NDW - 1 of dK and dV
  const int kr0 = 16 * (warp / CS);
  const int cw = (warp % CS) * NDW;
  const fb_bf16* ka = Ks + (kr0 + (lane & 15)) * LD + 8 * (lane >> 4);
  const fb_bf16* va = Vs + (kr0 + (lane & 15)) * LD + 8 * (lane >> 4);
  const int b_ld = ((lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1);
  const int t_ld = ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
  uint32_t kf[KR ? NDC : 1][4], vf[KR ? NDC : 1][4];
  float dka[2 * NDW][4], dva[2 * NDW][4];
#pragma unroll
  for (int i = 0; i < 2 * NDW; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) stage_q(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (KR && it == 0) {
#pragma unroll
      for (int kc = 0; kc < (KR ? NDC : 1); ++kc) {
        ldmatrix_x4(kf[kc], ka + 16 * kc);
        ldmatrix_x4(vf[kc], va + 16 * kc);
      }
    }
    const fb_bf16* Qt = Qs + st * BM * LD;
    const fb_bf16* dOt = dOs + st * BM * LD;
    const float* Lt = Ls + st * BM;
    const float* Dt = Dl + st * BM;
    const int qt0 = (t_begin + it % ntile) * BM;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys by BM queries
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NDC; ++kc) {
      uint32_t a[4], av[4];
      if (KR) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[j] = kf[KR ? kc : 0][j];
          av[j] = vf[KR ? kc : 0][j];
        }
      } else {
        ldmatrix_x4(a, ka + 16 * kc);
        ldmatrix_x4(av, va + 16 * kc);
      }
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t bq[4], bd[4];
        ldmatrix_x4(bq, Qt + 16 * n2 * LD + b_ld + 16 * kc);
        ldmatrix_x4(bd, dOt + 16 * n2 * LD + b_ld + 16 * kc);
        mma_bf16(s[2 * n2], a, bq[0], bq[1]);
        mma_bf16(s[2 * n2 + 1], a, bq[2], bq[3]);
        mma_bf16(dp[2 * n2], av, bd[0], bd[1]);
        mma_bf16(dp[2 * n2 + 1], av, bd[2], bd[3]);
      }
    }

    // P^T into s, dS^T = P^T (dP^T - delta) into dp; the tile's query of
    // column col has lse Lt[col] and delta Dt[col]
    const bool edge = k0 + BK > nk ||
                      (causal && qt0 + q_offset < k0 + BK - 1) ||
                      (window > 0 && qt0 + BM - 1 + q_offset - k0 >= window);
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 8 * i + 2 * tq + (j & 1);
        float x = s[i][j] * scale_log2;
        if (edge) {
          const int kpos = k0 + kr0 + g + 8 * (j >> 1);
          const int qpos = qt0 + col + q_offset;
          bool ok = kpos < nk;
          if (causal) ok = ok && qpos >= kpos;
          if (window > 0) ok = ok && (qpos - kpos) < window;
          x = ok ? x : FB_NEG;
        }
        const float lc = Lt[col];
        const float p = lc > FB_NO_KEY
                            ? fast_exp2(fminf(x - lc * FB_LOG2E, 0.f)) : 0.f;
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - Dt[col]);
      }

    // dV += P^T dO and dK += dS^T Q over this warp's column chunks: P and
    // dS rounded to bf16 as A operands, dO and Q read transposed
#pragma unroll
    for (int kc = 0; kc < BM / 16; ++kc) {
      uint32_t ap[4], as[4];
      pack_a(ap, s[2 * kc], s[2 * kc + 1]);
      pack_a(as, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
      for (int d2 = 0; d2 < NDW; ++d2) {
        uint32_t bd[4], bq[4];
        ldmatrix_x4_trans(bd, dOt + 16 * kc * LD + t_ld + 16 * (cw + d2));
        ldmatrix_x4_trans(bq, Qt + 16 * kc * LD + t_ld + 16 * (cw + d2));
        mma_bf16(dva[2 * d2], ap, bd[0], bd[1]);
        mma_bf16(dva[2 * d2 + 1], ap, bd[2], bd[3]);
        mma_bf16(dka[2 * d2], as, bq[0], bq[1]);
        mma_bf16(dka[2 * d2 + 1], as, bq[2], bq[3]);
      }
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }
  cp_async_wait<0>();

  // every key row of the tile below Sk is written: zeros where no query
  // sees it
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + kr0 + g + 8 * h;
    if (key >= Sk) continue;
    const long long at = kv_off + static_cast<long long>(key) * D;
#pragma unroll
    for (int i = 0; i < 2 * NDW; ++i) {
      const int col = 16 * cw + 8 * i + 2 * tq;
      store_pair(dk + at, col, D, dka[i][2 * h] * scale,
                 dka[i][2 * h + 1] * scale, vec);
      store_pair(dv + at, col, D, dva[i][2 * h], dva[i][2 * h + 1], vec);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// the instantiations (16-wide chunks of D), as the forward's; a D between
// two takes the next larger
#define FB_CHUNKS(X) X(1) X(2) X(4) X(5) X(6) X(8) X(12) X(16)

// Opt every instantiation into the shared memory it needs, once: the first
// launch is eager, so a graph capture makes no call.
static cudaError_t ensure_smem_attrs() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaSuccess;
#define FB_OPT(N)                                                         \
  if (e == cudaSuccess)                                                   \
    e = allow_dynamic_smem(flash_bwd_dq_kernel<N>,                        \
                           FlashBwdShape<N>::DQ_SMEM);                    \
  if (e == cudaSuccess)                                                   \
    e = allow_dynamic_smem(flash_bwd_dkdv_kernel<N>,                      \
                           FlashBwdShape<N>::DKDV_SMEM);
  FB_CHUNKS(FB_OPT)
#undef FB_OPT
  done = e == cudaSuccess;
  return e;
}

// dtype: 1 = bfloat16 (q, k, v, out, dout, dq, dk, dv share it), the only
// type taken; lse and delta (BH, Sq) f32; kv_len null or (BH / q_per_kv,)
// int32 on the device.  Enqueues flash_bwd_dq_kernel (which writes delta)
// then flash_bwd_dkdv_kernel (which reads it) on the stream.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   const void* kv_len, int BH, int Sq, int Sk,
                                   int D, int q_per_kv, int causal,
                                   int window, int dtype, void* stream) {
  if (D < 1 || D > FB_MAX_D || q_per_kv < 1 || BH % q_per_kv != 0 ||
      window < 0 || Sq < 0 || Sk < 0 || dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0) return static_cast<int>(cudaSuccess);
  cudaError_t e = ensure_smem_attrs();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_len);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const float scale_log2 = scale * FB_LOG2E;
  const int BKV = BH / q_per_kv;
  const uintptr_t any_bits =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
      reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
      reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  const bool vec = D % 8 == 0 && any_bits % 16 == 0;  // all 16-byte aligned
  const fb_bf16* qb = static_cast<const fb_bf16*>(q);
  const fb_bf16* kb = static_cast<const fb_bf16*>(k);
  const fb_bf16* vb = static_cast<const fb_bf16*>(v);
  const fb_bf16* dob = static_cast<const fb_bf16*>(dout);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  const int nc = (D + 15) / 16;
#define FB_LAUNCH(N)                                                        \
  if (nc <= N) {                                                            \
    using Sh = FlashBwdShape<N>;                                            \
    const int nq = (Sq + Sh::BQ - 1) / Sh::BQ;                              \
    const int nkb = (Sk + Sh::BK - 1) / Sh::BK;                             \
    if (nq > 65535 || nkb > 65535) return cudaErrorInvalidConfiguration;   \
    if (nq > 0) {                                                           \
      flash_bwd_dq_kernel<N><<<dim3(BH, nq), Sh::NTHR, Sh::DQ_SMEM,       \
                               st>>>(                                       \
          qb, kb, vb, static_cast<const fb_bf16*>(out), dob, lf, df,        \
          static_cast<fb_bf16*>(dq), lens, Sq, Sk, D, q_per_kv, causal,     \
          window, scale_log2, scale, vec ? 1 : 0);                          \
      const cudaError_t le = cudaGetLastError();                            \
      if (le != cudaSuccess) return le;                                     \
    }                                                                       \
    if (nkb > 0)                                                            \
      flash_bwd_dkdv_kernel<N><<<dim3(BKV, nkb), Sh::NTHR,                \
                                 Sh::DKDV_SMEM, st>>>(                      \
          qb, kb, vb, dob, lf, df, static_cast<fb_bf16*>(dk),               \
          static_cast<fb_bf16*>(dv), lens, Sq, Sk, D, q_per_kv, causal,     \
          window, scale_log2, scale, vec ? 1 : 0);                          \
    return cudaGetLastError();                                              \
  }
  auto run = [&]() -> cudaError_t {
    FB_CHUNKS(FB_LAUNCH)
    return cudaErrorInvalidValue;
  };
#undef FB_LAUNCH
  return static_cast<int>(run());
}
