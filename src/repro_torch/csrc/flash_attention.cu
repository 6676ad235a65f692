// flash_attention: blockwise streaming-softmax attention (forward only),
// causal and sliding-window masks, per-row key counts, GQA by index.
//
//   s[b, i, j] = (q[b, i] . k[b / G, j]) * D^-0.5
//   masked to -1e30 unless  j < n_b = min(Sk, kv_len[b / G]) (Sk without
//                                     kv_len)
//                      and  (not causal or i + q_offset >= j)
//                      and  (window == 0 or i + q_offset - j < window)
//   p = exp(s - m) against the running row max m, summed in f32 into l,
//   rounded to v's type, and out[b, i] = (sum_j p_j v[b / G, j]) / l,
//   q_offset = Sk - Sq
//   q (BH, Sq, D), k/v (BKV, Sk, D), kv_len (BKV,) int32 or null
//   -> out (BH, Sq, D), BH = BKV * G, and, where lse is not null, the row
//   log-sum-exp lse (BH, Sq) f32 = m + log l in natural log (the mma
//   kernel's log2-domain m + log2 l times ln 2), what the backward
//   (csrc/flash_attention_bwd.cu) rebuilds P from
//   f32 or bf16 in, f32 accumulation, output in q's type; a row with no
//   visible key at all (kv_len 0, a causal query before the first key
//   when Sq > Sk, a window wholly past the count) writes zeros and an lse
//   of about -1e30, from which the backward gives it zero gradients
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (body _flash_kernel): grid (BH, nq, nk) with the KV axis sequential and
// f32 (m, l, acc) scratch in VMEM, masks computed from program ids, GQA
// through the k/v index maps (KV never repeated in memory), p rounded to
// v's type before p.v (`p.astype(v.dtype)`).  The TPU kernel has no key
// count: the reference runs its cross-attention (queries over an encoder
// memory of ragged valid length) through its plain-JAX flash attention's
// `valid_len`, which kv_len carries here.  A row's count only narrows the
// key range its blocks walk: keys past it are neither staged nor scored,
// and the tile that crosses it takes the edge mask, as the Sk edge does.
//
// What bounds it here: at training and prefill lengths, operations —
// 4 FLOPs per unmasked (query, key) pair per head element against bytes
// that grow only linearly in the sequence (at the stablelm_3b train_4k
// shape in chip_smoke.py, ~172 GFLOP against ~168 MB, bound ~0.17 ms at
// the bf16 tensor-core peak).
//
// bf16 design (flash_mma_kernel): both products on the tensor cores with
// warp-level mma.sync.m16n8k16 (f32 accumulation), operands read from
// shared memory by ldmatrix.  wgmma would reach further, but its shared-
// memory descriptors cannot be checked without the card, and mma.sync
// keeps the score tile and P in the registers of one warp.  One block per
// (row b, tile of 128 queries): up to D = 96, 4 warps of 32 query rows
// (two 16-row m-tiles, so each K and V fragment read from shared memory
// serves two products), registers cut to fit 2 blocks an SM; above, 8
// warps of 16 rows.  Each warp keeps its Q fragments (in registers while
// they fit, else re-read from shared memory), its (m, l) pairs and its f32
// output accumulators in registers.  K/V tiles of 64 keys (32 above D =
// 128, for registers) stream through a 2-stage ring filled by 16-byte
// cp.async copies while the previous tile computes.  The head dim is
// zero-padded to a multiple of 16 (the mma depth) in shared memory: zero
// columns change no dot product, so one code path takes every D up to
// 256, instantiated per count of 16-wide chunks.  The online softmax runs
// in registers in the log2 domain (scores pre-multiplied by D^-0.5 *
// log2 e, exponentials on the special-function unit), with the TPU
// kernel's -1e30 masking and (m, l) correction; P is rounded to bf16 in
// registers and fed as the A operand of P.V straight from the score
// accumulators.  Only tiles that cross a mask edge evaluate the mask;
// tiles masked for every query of the block are skipped, and the q-tile
// order is reversed so the longest causal tiles are scheduled first.
//
// f32 design (flash_ffma_kernel): CUDA-core FFMA out of shared memory.
// TF32 or bf16 tensor cores would round q, k and p and break the 2e-5
// parity the f32 paths and the CPU tests hold.  One block of 256 threads
// per (row b, tile of 32 queries), 8 threads per query row, each holding
// 4 of a 32-key tile's scores and 1/8 of the row's accumulator.
//
// Masked scores use -1e30, not -inf: a row whose first tiles are fully
// masked (a sliding window) keeps a finite running max, and the
// correction exp(-1e30 - m) zeroes what it summed once a valid key
// arrives, as in the TPU kernel.  The lse output is written only when
// asked for (training), one value a row after the last tile: prefill and
// serving pass a null pointer and write nothing more.  Shared memory past
// 48 KB is opted into
// once, for every instantiation, at the first launch (which is eager), so
// a launch inside a CUDA-graph capture makes no attribute call.
#include "common.cuh"
#include "mma.cuh"

#include <cuda_bf16.h>
#include <math.h>

#define FA_MAX_D 256
#define FA_NEG -1e30f
#define FA_LOG2E 1.4426950408889634f
#define FA_LN2 0.6931471805599453f

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

#define FM_BM 128        // queries per block
#define FM_MT_MAX_NDC 6  // widest D (in 16-column chunks) with 2 m-tiles a
                         // warp; wider takes 1 for registers
#define FM_MIN_BLOCKS 2  // with 2 m-tiles: registers cut to fit 2 blocks

template <int NDC>
struct FlashMmaShape {
  static constexpr int DP = 16 * NDC;            // padded head dim
  static constexpr int LD = DP + 8;              // smem row stride: no bank
                                                 // conflicts for ldmatrix
  static constexpr int MT = NDC <= FM_MT_MAX_NDC ? 2 : 1;  // 16-row m-tiles
                                                           // per warp
  static constexpr int WARPS = FM_BM / (16 * MT);
  static constexpr int BN = NDC <= 8 ? 64 : 32;  // keys per tile
  static constexpr bool Q_IN_REGS = MT * NDC <= 8;
  static constexpr int MIN_BLOCKS = MT == 2 ? FM_MIN_BLOCKS : 1;
  static constexpr size_t SMEM =
      static_cast<size_t>(FM_BM + 4 * BN) * LD * sizeof(__nv_bfloat16);
};

template <int NDC>
__global__ void __launch_bounds__(FlashMmaShape<NDC>::WARPS * 32,
                                  FlashMmaShape<NDC>::MIN_BLOCKS)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out,
                 const int* __restrict__ kv_len, float* __restrict__ lse,
                 int Sq, int Sk, int D, int q_per_kv, int causal, int window,
                 float scale_log2, int vec) {
  using Sh = FlashMmaShape<NDC>;
  constexpr int LD = Sh::LD, BN = Sh::BN, NT = BN / 8, MT = Sh::MT;
  constexpr int NTHR = Sh::WARPS * 32, QR = Sh::Q_IN_REGS ? 1 : 0;
  extern __shared__ __align__(16) unsigned char fm_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(fm_smem);
  __nv_bfloat16* Ks = Qs + FM_BM * LD;  // 2 stages of BN rows
  __nv_bfloat16* Vs = Ks + 2 * BN * LD;

  const int nq = (Sq + FM_BM - 1) / FM_BM;
  const int b = blockIdx.x;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * FM_BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q_offset = Sk - Sq;
  const __nv_bfloat16* qb = q + static_cast<long long>(b) * Sq * D;
  const long long kv_off = static_cast<long long>(b / q_per_kv) * Sk * D;
  const __nv_bfloat16* kb = k + kv_off;
  const __nv_bfloat16* vb = v + kv_off;
  // the keys this row has: its count, at most Sk
  const int nk = kv_len ? max(0, min(Sk, kv_len[b / q_per_kv])) : Sk;

  // key range any query of this tile can see
  const int q_first = q0 + q_offset;
  const int q_last = min(q0 + FM_BM, Sq) - 1 + q_offset;
  int kv_lo = 0, kv_hi = nk;
  if (causal) kv_hi = min(nk, q_last + 1);
  if (window > 0) kv_lo = max(0, q_first - window + 1);
  const int t_begin = kv_lo / BN;
  const int t_end = kv_hi > kv_lo ? (kv_hi + BN - 1) / BN : t_begin;

  stage_rows<__nv_bfloat16, Sh::DP>(Qs, LD, qb + static_cast<long long>(q0) * D,
                                    D, Sq - q0, FM_BM, D, vec, tid, NTHR);
  auto stage_kv = [&](int t, int st) {
    const int k0 = t * BN;
    const long long off = static_cast<long long>(k0) * D;
    stage_rows<__nv_bfloat16, Sh::DP>(Ks + st * BN * LD, LD, kb + off, D,
                                      nk - k0, BN, D, vec, tid, NTHR);
    stage_rows<__nv_bfloat16, Sh::DP>(Vs + st * BN * LD, LD, vb + off, D,
                                      nk - k0, BN, D, vec, tid, NTHR);
  };
  if (t_begin < t_end) stage_kv(t_begin, 0);
  cp_async_commit();

  // this warp's rows: 16 MT from row0; m-tile mt holds rows row0 + 16 mt
  // + g and + g + 8
  const int row0 = 16 * MT * warp;
  float o[MT][2 * NDC][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2 * NDC; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[mt][i][j] = 0.f;
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mt][h] = FA_NEG;
      l[mt][h] = 0.f;
    }
  uint32_t qf[QR ? MT : 1][QR ? NDC : 1][4];

  // ldmatrix lane offsets: A (rows i % 16, cols 8 (i / 16)); B from
  // row-major K (rows i % 8 + 8 (i / 16), cols 8 ((i / 8) % 2)); B from
  // row-major V, transposed (rows i % 8 + 8 ((i / 8) % 2), cols 8 (i / 16))
  const __nv_bfloat16* qa = Qs + (row0 + (lane & 15)) * LD + 8 * (lane >> 4);
  const int k_ld = ((lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1);
  const int v_ld = ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    if (t + 1 < t_end) stage_kv(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + st * BN * LD;
    const __nv_bfloat16* Vt = Vs + st * BN * LD;
    if (QR && t == t_begin) {
#pragma unroll
      for (int mt = 0; mt < (QR ? MT : 1); ++mt)
#pragma unroll
        for (int kc = 0; kc < (QR ? NDC : 1); ++kc)
          ldmatrix_x4(qf[mt][kc], qa + 16 * mt * LD + 16 * kc);
    }

    // S = Q K^T for this warp's rows and the tile's BN keys; each K
    // fragment serves the warp's MT m-tiles
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[mt][i][j] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NDC; ++kc) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (QR) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            a[mt][j] = qf[QR ? mt : 0][QR ? kc : 0][j];
        } else {
          ldmatrix_x4(a[mt], qa + 16 * mt * LD + 16 * kc);
        }
      }
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, Kt + 16 * n2 * LD + k_ld + 16 * kc);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * n2], a[mt], bk[0], bk[1]);
          mma_bf16(s[mt][2 * n2 + 1], a[mt], bk[2], bk[3]);
        }
      }
    }

    // scale to the log2 domain; mask only tiles that cross a mask edge
    const int k0 = t * BN;
    const bool edge = k0 + BN > nk || (causal && k0 + BN - 1 > q0 + q_offset) ||
                      (window > 0 && k0 < q_last - window + 1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[mt][i][j] * scale_log2;
          if (edge) {
            const int kpos = k0 + 8 * i + 2 * tq + (j & 1);
            const int qpos = q0 + row0 + 16 * mt + g + 8 * (j >> 1) + q_offset;
            bool ok = kpos < nk;
            if (causal) ok = ok && qpos >= kpos;
            if (window > 0) ok = ok && (qpos - kpos) < window;
            x = ok ? x : FA_NEG;
          }
          s[mt][i][j] = x;
        }

    // online softmax: rows g (j = 0, 1) and g + 8 (j = 2, 3) of each
    // m-tile, each row's 4 threads (a quad) reduce by shuffles
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = m[mt][h];
#pragma unroll
        for (int i = 0; i < NT; ++i)
          mx = fmaxf(mx, fmaxf(s[mt][i][2 * h], s[mt][i][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        corr[h] = fast_exp2(m[mt][h] - mx);
        m[mt][h] = mx;
        float ps = 0.f;
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          s[mt][i][2 * h] = fast_exp2(s[mt][i][2 * h] - mx);
          s[mt][i][2 * h + 1] = fast_exp2(s[mt][i][2 * h + 1] - mx);
          ps += s[mt][i][2 * h] + s[mt][i][2 * h + 1];
        }
        l[mt][h] = l[mt][h] * corr[h] + ps;  // this thread's columns
      }
#pragma unroll
      for (int i = 0; i < 2 * NDC; ++i) {
        o[mt][i][0] *= corr[0];
        o[mt][i][1] *= corr[0];
        o[mt][i][2] *= corr[1];
        o[mt][i][3] *= corr[1];
      }
    }

    // O += P V: P rounded to bf16 in registers as the A operand; each V
    // fragment serves the warp's MT m-tiles
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kc][0], s[mt][2 * kc][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kc][2], s[mt][2 * kc][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kc + 1][0], s[mt][2 * kc + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kc + 1][2], s[mt][2 * kc + 1][3]);
      }
#pragma unroll
      for (int d2 = 0; d2 < NDC; ++d2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vt + 16 * kc * LD + v_ld + 16 * d2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * d2], a[mt], bv[0], bv[1]);
          mma_bf16(o[mt][2 * d2 + 1], a[mt], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[mt][h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int row = q0 + row0 + 16 * mt + g + 8 * h;
      if (row >= Sq) continue;
      if (lse && tq == 0)
        lse[static_cast<long long>(b) * Sq + row] =
            (m[mt][h] + log2f(fmaxf(lt, 1e-30f))) * FA_LN2;
      // a row that saw no key kept m at -1e30: zeros, as a count of 0
      const float inv = m[mt][h] > 0.5f * FA_NEG ? 1.f / fmaxf(lt, 1e-30f)
                                                 : 0.f;
      __nv_bfloat16* orow = out + (static_cast<long long>(b) * Sq + row) * D;
#pragma unroll
      for (int i = 0; i < 2 * NDC; ++i) {
        const int c = 8 * i + 2 * tq;
        const float x0 = o[mt][i][2 * h] * inv, x1 = o[mt][i][2 * h + 1] * inv;
        if (vec) {  // D is a multiple of 8: the pair is in range
          if (c < D)
            *reinterpret_cast<__nv_bfloat162*>(orow + c) =
                __floats2bfloat162_rn(x0, x1);
        } else {
          if (c < D) orow[c] = __float2bfloat16(x0);
          if (c + 1 < D) orow[c + 1] = __float2bfloat16(x1);
        }
      }
    }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

#define FA_BQ 32
#define FA_BK 32
#define FA_TPR 8  // threads per query row
#define FA_THREADS (FA_BQ * FA_TPR)

__device__ __forceinline__ float row_max8(float x) {
#pragma unroll
  for (int off = FA_TPR / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum8(float x) {
#pragma unroll
  for (int off = FA_TPR / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

static size_t ffma_smem(int D) {
  return (static_cast<size_t>(FA_BQ + 2 * FA_BK) * (D + 1) +
          static_cast<size_t>(FA_BQ) * (FA_BK + 1)) *
         sizeof(float);
}

// NJ = accumulator columns per thread: D <= FA_TPR * NJ
template <int NJ>
__global__ void __launch_bounds__(FA_THREADS)
flash_ffma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  const int* __restrict__ kv_len, float* __restrict__ lse,
                  int Sq, int Sk, int D, int q_per_kv, int causal,
                  int window, float scale) {
  extern __shared__ float smem[];
  constexpr int SC = FA_BK / FA_TPR;  // scores per thread per tile
  const int DP = D + 1;
  float* Qs = smem;                // (BQ, DP)
  float* Ks = Qs + FA_BQ * DP;     // (BK, DP)
  float* Vs = Ks + FA_BK * DP;     // (BK, DP)
  float* Ps = Vs + FA_BK * DP;     // (BQ, BK + 1)

  const int nq = (Sq + FA_BQ - 1) / FA_BQ;
  const int b = blockIdx.x;
  const int tile = nq - 1 - static_cast<int>(blockIdx.y);
  const int q0 = tile * FA_BQ;
  const int t = threadIdx.x;
  const int r = t / FA_TPR;
  const int cl = t - r * FA_TPR;
  const int q_offset = Sk - Sq;
  const int qpos = q0 + r + q_offset;
  const float* qb = q + static_cast<long long>(b) * Sq * D;
  const long long kv_off = static_cast<long long>(b / q_per_kv) * Sk * D;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;
  // the keys this row has: its count, at most Sk
  const int nk = kv_len ? max(0, min(Sk, kv_len[b / q_per_kv])) : Sk;

  for (int e = t; e < FA_BQ * D; e += FA_THREADS) {
    const int rr = e / D;
    const int d = e - rr * D;
    Qs[rr * DP + d] =
        (q0 + rr < Sq) ? qb[static_cast<long long>(q0 + rr) * D + d] : 0.f;
  }

  const int q_first = q0 + q_offset;
  const int q_last = min(q0 + FA_BQ, Sq) - 1 + q_offset;
  int kv_lo = 0, kv_hi = nk;
  if (causal) kv_hi = min(nk, q_last + 1);
  if (window > 0) kv_lo = max(0, q_first - window + 1);

  float m = FA_NEG, l = 0.f;
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;

  for (int k0 = (kv_lo / FA_BK) * FA_BK; k0 < kv_hi; k0 += FA_BK) {
    __syncthreads();  // the previous tile is consumed (and Qs is written)
    for (int e = t; e < FA_BK * D; e += FA_THREADS) {
      const int rr = e / D;
      const int d = e - rr * D;
      const bool ok = k0 + rr < nk;
      const long long gi = static_cast<long long>(k0 + rr) * D + d;
      Ks[rr * DP + d] = ok ? kb[gi] : 0.f;
      Vs[rr * DP + d] = ok ? vb[gi] : 0.f;
    }
    __syncthreads();

    float s[SC];
#pragma unroll
    for (int c = 0; c < SC; ++c) s[c] = 0.f;
    const float* qr = Qs + r * DP;
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int c = 0; c < SC; ++c)
        s[c] = fmaf(qd, Ks[(cl + FA_TPR * c) * DP + d], s[c]);
    }
    float mx = m;
#pragma unroll
    for (int c = 0; c < SC; ++c) {
      const int kpos = k0 + cl + FA_TPR * c;
      bool ok = kpos < nk;
      if (causal) ok = ok && qpos >= kpos;
      if (window > 0) ok = ok && (qpos - kpos) < window;
      s[c] = ok ? s[c] * scale : FA_NEG;
      mx = fmaxf(mx, s[c]);
    }
    mx = row_max8(mx);
    const float corr = expf(m - mx);
    float ps = 0.f;
    float* pr = Ps + r * (FA_BK + 1);
#pragma unroll
    for (int c = 0; c < SC; ++c) {
      const float p = expf(s[c] - mx);
      pr[cl + FA_TPR * c] = p;
      ps += p;
    }
    l = l * corr + row_sum8(ps);
    m = mx;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] *= corr;
    __syncwarp();  // the row's 8 threads share one warp
    for (int c = 0; c < FA_BK; ++c) {
      const float p = pr[c];
      const float* vr = Vs + c * DP;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = cl + FA_TPR * j;
        if (d < D) acc[j] = fmaf(p, vr[d], acc[j]);
      }
    }
    __syncwarp();
  }

  if (q0 + r < Sq) {
    if (lse && cl == 0)
      lse[static_cast<long long>(b) * Sq + q0 + r] =
          m + logf(fmaxf(l, 1e-30f));
    const float inv = m > 0.5f * FA_NEG ? 1.f / fmaxf(l, 1e-30f) : 0.f;
    float* orow = out + (static_cast<long long>(b) * Sq + q0 + r) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = cl + FA_TPR * j;
      if (d < D) orow[d] = acc[j] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// the mma instantiations (16-wide chunks of D) and the FFMA ones (columns
// per thread); a D between two takes the next larger
#define FA_MMA_CHUNKS(X) X(1) X(2) X(4) X(5) X(6) X(8) X(12) X(16)
#define FA_FFMA_COLS(X) X(1) X(2) X(4) X(8) X(16) X(32)

// Opt every instantiation into the shared memory its largest launch needs,
// once: the first launch is eager, so a graph capture makes no call.
static cudaError_t ensure_smem_attrs() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaSuccess;
#define FA_OPT_MMA(N)                                                   \
  if (e == cudaSuccess)                                                 \
    e = allow_dynamic_smem(flash_mma_kernel<N>, FlashMmaShape<N>::SMEM);
#define FA_OPT_FFMA(N)                                                  \
  if (e == cudaSuccess)                                                 \
    e = allow_dynamic_smem(flash_ffma_kernel<N>,                        \
                           ffma_smem(FA_TPR * (N) < FA_MAX_D ? FA_TPR * (N) \
                                                             : FA_MAX_D));
  FA_MMA_CHUNKS(FA_OPT_MMA)
  FA_FFMA_COLS(FA_OPT_FFMA)
#undef FA_OPT_MMA
#undef FA_OPT_FFMA
  done = e == cudaSuccess;
  return e;
}

static cudaError_t launch_mma(const void* q, const void* k, const void* v,
                              void* out, const int* kv_len, float* lse,
                              int BH, int Sq,
                              int Sk, int D, int q_per_kv, int causal,
                              int window, cudaStream_t stream) {
  const float scale_log2 =
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))) * FA_LOG2E;
  const int nq = (Sq + FM_BM - 1) / FM_BM;
  if (nq > 65535) return cudaErrorInvalidConfiguration;
  const bool vec = D % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(BH, nq);
  const int nc = (D + 15) / 16;
#define FA_LAUNCH_MMA(N)                                                    \
  if (nc <= N) {                                                            \
    flash_mma_kernel<N><<<grid, FlashMmaShape<N>::WARPS * 32,               \
                          FlashMmaShape<N>::SMEM, stream>>>(                \
        static_cast<const __nv_bfloat16*>(q),                               \
        static_cast<const __nv_bfloat16*>(k),                               \
        static_cast<const __nv_bfloat16*>(v),                               \
        static_cast<__nv_bfloat16*>(out), kv_len, lse, Sq, Sk, D, q_per_kv, \
        causal, window, scale_log2, vec ? 1 : 0);                           \
    return cudaGetLastError();                                              \
  }
  FA_MMA_CHUNKS(FA_LAUNCH_MMA)
#undef FA_LAUNCH_MMA
  return cudaErrorInvalidValue;
}

static cudaError_t launch_ffma(const void* q, const void* k, const void* v,
                               void* out, const int* kv_len, float* lse,
                               int BH, int Sq,
                               int Sk, int D, int q_per_kv, int causal,
                               int window, cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const int nq = (Sq + FA_BQ - 1) / FA_BQ;
  if (nq > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(BH, nq);
  const size_t smem = ffma_smem(D);
  const int nj = (D + FA_TPR - 1) / FA_TPR;
#define FA_LAUNCH_FFMA(N)                                                  \
  if (nj <= N) {                                                           \
    flash_ffma_kernel<N><<<grid, FA_THREADS, smem, stream>>>(              \
        static_cast<const float*>(q), static_cast<const float*>(k),        \
        static_cast<const float*>(v), static_cast<float*>(out), kv_len,    \
        lse, Sq, Sk, D, q_per_kv, causal, window, scale);                  \
    return cudaGetLastError();                                             \
  }
  FA_FFMA_COLS(FA_LAUNCH_FFMA)
#undef FA_LAUNCH_FFMA
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it); kv_len
// null or (BH / q_per_kv,) int32 on the device; lse null (no gradient
// needed) or (BH, Sq) f32 on the device
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, const void* kv_len, void* lse,
                               int BH, int Sq, int Sk, int D, int q_per_kv,
                               int causal, int window, int dtype,
                               void* stream) {
  if (D < 1 || D > FA_MAX_D || q_per_kv < 1 || BH % q_per_kv != 0 ||
      window < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || Sq == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t e = ensure_smem_attrs();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_len);
  float* lf = static_cast<float*>(lse);
  if (dtype == 0)
    return static_cast<int>(launch_ffma(q, k, v, out, lens, lf, BH, Sq, Sk,
                                        D, q_per_kv, causal, window, st));
  return static_cast<int>(launch_mma(q, k, v, out, lens, lf, BH, Sq, Sk, D,
                                     q_per_kv, causal, window, st));
}
