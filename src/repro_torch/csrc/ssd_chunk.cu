// ssd_chunk: the Mamba2 SSD intra-chunk block plus the carry-in of the
// state entering the chunk, for one (batch, chunk, head) row per block.
//
//   w[i, j] = (C[i] . B[j]) * exp(cum[i] - cum[j])   for j <= i, else 0
//   y[i]    = sum_j round_T(w[i, j]) * xw[j]  +  exp(cum[i]) * (C[i] . h_in)
//   cb/bb (R / heads, Q, N), xw (R, Q, P), h_in (R, N, P) in T (f32 or
//   bf16); cum (R, Q) f32 -> y (R, Q, P) in T.  Row r reads C and B of
//   row r / heads: the heads of one (batch, chunk) share B and C (Mamba2's
//   single group), so they are passed once and never replicated.
//   f32 accumulation; w is rounded to T before w . xw, as the TPU kernel
//   casts it to xw's type before its second matmul.
//
// Replaces: src/repro/kernels/ssd_chunk.py, ssd_chunk_pallas (body
// _ssd_kernel): grid (BCH,), each cell a (Q, Q) score matmul on the MXU,
// the causal decay applied in VMEM, a (Q, Q) x (Q, P) matmul and the
// (Q, N) x (N, P) carry, all with f32 accumulation.
//
// What bounds it here: at the realistic shape in chip_smoke.py
// (prefill_32k x zamba2 with the batch cut to 2: 20480 rows of Q = 256,
// N = P = 64, bf16, 80 heads a group) the causal half of w . xw plus the
// carry is ~130 GFLOP, and the scores, once per (batch, chunk) group,
// ~1 GFLOP, against ~1.5 GB of unique bytes: below the card's bf16 ridge
// (~295 FLOP a byte), so on tensor cores it is bound by bytes (~0.46 ms).
//
// bf16 design: two kernels.  ssd_scores_kernel computes S = C . B^T once
// per (batch, chunk) group (the heads of a group share it), each entry
// one chain of f32 FMAs in n order, into an f32 scratch the wrapper
// allocates.  That order is the plain version's (kernels/ssd_chunk.py):
// w is rounded to bf16, and a score summed in another order (the tensor
// cores' own) lands on the other side of a rounding boundary of w now and
// then, which moves y by up to 2^-8 |w| |xw|, past the bf16 tolerance; in
// this order w is the plain version's bit for bit.  Once per group the
// FMA work is small (~1.3 GFLOP at the shape above).
//
// ssd_mma_kernel then runs the two per-head products on the tensor cores:
// warp-level mma.sync.m16n8k16 with f32 accumulation, operands read from
// shared memory by ldmatrix (csrc/mma.cuh).  One block of 8 warps per row
// stages the row's whole chunk once, with 16-byte cp.async copies: C of
// its group, xw, h_in (N and P zero-padded to multiples of 16, rows past
// Q zero-filled) and cum; ~73 KB at Q = 256, N = P = 64, so 3 blocks
// share an SM (registers are cut to fit them) and one block's copies
// overlap the others' products.  Tiles are stored without padding, their
// 16-byte chunks XOR-swizzled by row, so ldmatrix reads them without bank
// conflicts.  After one barrier the warps run independently over 16-row
// query tiles, dealt in snake order (warp w takes tiles w and 2W-1-w,
// ...) so the causal triangle's work is even across warps.  For a query
// tile a warp starts its f32 output fragments at the carry-in exp(cum_i)
// * (C_i . h_in) (an mma product), then walks the 16-key tiles on or
// below the diagonal: its scores read from S (one tile ahead, from L2),
// the decay applied to them in registers (f32 exp of cum_i - cum_j; the
// causal mask only on the diagonal tile, masked entries set to 0 without
// using the exp), w rounded to bf16 in pairs and fed as the A operand of
// w . xw_j straight from the registers, as flash feeds P.  Every byte of
// xw, h_in and cum is read from device memory once per row and y written
// once; every block carries the same triangle, so no launch order is
// needed.  Rows whose chunk does not fit a block's shared memory (Q past
// ~850 at N = P = 64, ~550 at N = 128) take the FFMA kernel below,
// chosen by shape: its scores are the same FMA chain.
//
// f32 design (ssd_ffma_kernel): CUDA-core FFMA out of shared memory; TF32
// would round C, B and w and break the f32 parity.  One block of 256
// threads per row; the (Q, Q) score tile is cut into 64 x 64 tiles.  For
// each 64-row query tile the block keeps C_i (transposed) in shared
// memory and the 64 x P output tile in registers (a 4 x 4 micro-tile per
// thread), starts it at the carry-in, then walks the key tiles j <= i
// only: S = C_i . B_j^T into registers, the decay and causal mask there,
// w rounded to T and written transposed to shared memory, then acc += w .
// xw_j.  ~85 KB of shared memory at N = 64.
//
// Sizes: N <= 128, P <= 64, any Q; the edges are zero-filled and masked.
#include "common.cuh"
#include "mma.cuh"

#include <cuda_bf16.h>
#include <math.h>

#define SSD_THREADS 256
#define SSD_T 64           // query and key tile
#define SSD_LD (SSD_T + 4)  // padded leading dim of transposed tiles
#define SSD_PT 64          // output columns held per block (P <= 64)
#define SSD_MAX_N 128

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store_t(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_t(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

#define SM_WARPS 8
#define SM_THREADS (SM_WARPS * 32)
#define SM_MIN_BLOCKS 3  // registers cut to fit 3 blocks an SM
#define SM_SMEM_MAX 232448  // a block's shared memory on sm_90

typedef __nv_bfloat16 bf16;

// Physical 16-byte chunk of logical chunk `c` in row `r` of a tile of CPR
// chunks a row: XOR with the row's low bits, so the 8 rows one ldmatrix
// matrix reads land in 8 different chunks (conflict-free from 8 chunks a
// row, i.e. 64 columns, up; narrower tiles conflict 2- or 4-way).
template <int CPR>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int S = CPR < 8 ? CPR : 8;
  return c ^ (r & (S - 1));
}

// Stage `nrows` rows of DP columns into a swizzled tile: element (r, c) is
// src[r * D + c] where r < valid_rows and c < D, else 0.  With `vec` (D a
// multiple of 8, the source 16-byte aligned) as 16-byte cp.async copies
// (the caller commits and waits), otherwise plain loads and stores.
template <int DP>
__device__ __forceinline__ void stage_swz(bf16* dst, const bf16* src,
                                          int valid_rows, int nrows, int D,
                                          bool vec, int tid) {
  constexpr int CPR = DP / 8;
  if (vec) {
    for (int e = tid; e < nrows * CPR; e += SM_THREADS) {
      const int r = e / CPR, c = e - r * CPR;
      bf16* d = dst + r * DP + swz<CPR>(r, c) * 8;
      if (c * 8 < D) {
        const int rs = r < valid_rows ? r : 0;
        cp_async16(d, src + rs * D + c * 8, r < valid_rows);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      }
    }
  } else {
    for (int e = tid; e < nrows * DP; e += SM_THREADS) {
      const int r = e / DP, c = e - r * DP;
      dst[r * DP + swz<CPR>(r, c >> 3) * 8 + (c & 7)] =
          (r < valid_rows && c < D) ? src[r * D + c] : __float2bfloat16(0.f);
    }
  }
}

#define SC_T 64            // score tile
#define SC_LD (SC_T + 4)   // padded leading dim of the transposed tiles

static size_t ssd_scores_smem(int N) {
  return 2 * static_cast<size_t>(N) * SC_LD * sizeof(float);
}

// S[g] = C[g] . B[g]^T for one (batch, chunk) group g and one 64 x 64 tile
// on or below the diagonal (grid: (tiles, groups); the tiles numbered
// (0,0), (1,0), (1,1), (2,0), ...), as one chain of f32 FMAs in n order
// per entry: the order the plain version states, so that S, and with it
// w's rounding to bf16, is the plain version's bit for bit.  Rows and
// columns past Q are written as 0.  S is (groups, QS, QS), QS = Q rounded
// up to 64.
__global__ void __launch_bounds__(256)
ssd_scores_kernel(const bf16* __restrict__ cb, const bf16* __restrict__ bb,
                  float* __restrict__ S, int Q, int N, int QS) {
  extern __shared__ float4 sc_smem4[];
  float* Ct = reinterpret_cast<float*>(sc_smem4);  // [N][SC_LD]: C_i^T
  float* Bt = Ct + N * SC_LD;                      // [N][SC_LD]: B_j^T
  int k = blockIdx.x, ti = 0;
  while (k > ti) k -= ++ti;
  const int tj = k;
  const long long g = blockIdx.y;
  const int i0 = ti * SC_T, j0 = tj * SC_T;
  const bf16* cg = cb + g * Q * N;
  const bf16* bg = bb + g * Q * N;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  for (int idx = tid; idx < SC_T * N; idx += 256) {
    const int i = idx / N, n = idx % N;
    Ct[n * SC_LD + i] =
        i0 + i < Q ? __bfloat162float(cg[(i0 + i) * N + n]) : 0.f;
    Bt[n * SC_LD + i] =
        j0 + i < Q ? __bfloat162float(bg[(j0 + i) * N + n]) : 0.f;
  }
  __syncthreads();
  float s[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
  for (int n = 0; n < N; ++n) {
    const float4 ca = *reinterpret_cast<const float4*>(Ct + n * SC_LD + ty * 4);
    const float4 bj = *reinterpret_cast<const float4*>(Bt + n * SC_LD + tx * 4);
    const float av[4] = {ca.x, ca.y, ca.z, ca.w};
    const float bv[4] = {bj.x, bj.y, bj.z, bj.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = fmaf(av[a], bv[b], s[a][b]);
  }
  float* Sg = S + g * QS * QS;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    *reinterpret_cast<float4*>(Sg + static_cast<long long>(i0 + ty * 4 + a) *
                                        QS + j0 + tx * 4) =
        make_float4(s[a][0], s[a][1], s[a][2], s[a][3]);
}

static size_t ssd_mma_smem(int Q, int NC, int PC) {
  const size_t QP = (Q + 15) / 16 * 16, NP = 16 * NC, PP = 16 * PC;
  return (QP * NP + QP * PP + NP * PP) * sizeof(bf16) + QP * sizeof(float);
}

// NC, PC: N and P in 16-column chunks (zero-padded)
template <int NC, int PC>
__global__ void __launch_bounds__(SM_THREADS, SM_MIN_BLOCKS)
ssd_mma_kernel(const bf16* __restrict__ cb, const float* __restrict__ S,
               const bf16* __restrict__ xw, const float* __restrict__ cum,
               const bf16* __restrict__ hin, bf16* __restrict__ out, int Q,
               int N, int P, int heads, int QS, int vec_n, int vec_p) {
  constexpr int NP = 16 * NC, PP = 16 * PC, CN = 2 * NC, CP = 2 * PC;
  extern __shared__ __align__(16) unsigned char sm_smem[];
  const int QP = (Q + 15) & ~15;
  bf16* Cs = reinterpret_cast<bf16*>(sm_smem);  // [QP][NP]
  bf16* Xs = Cs + QP * NP;                      // [QP][PP]
  bf16* Hs = Xs + QP * PP;                      // [NP][PP]
  float* cs = reinterpret_cast<float*>(Hs + NP * PP);  // [QP]

  const long long r = blockIdx.x;
  const long long g = r / heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;

  stage_swz<NP>(Cs, cb + g * Q * N, Q, QP, N, vec_n, tid);
  stage_swz<PP>(Xs, xw + r * Q * P, Q, QP, P, vec_p, tid);
  stage_swz<PP>(Hs, hin + r * N * P, N, NP, P, vec_p, tid);
  cp_async_commit();
  for (int i = tid; i < QP; i += SM_THREADS)
    cs[i] = i < Q ? cum[r * Q + i] : 0.f;
  cp_async_wait<0>();
  __syncthreads();

  // ldmatrix lanes: A from row-major C (rows lane % 16, chunk lane / 16);
  // B from row-major xw or h_in, transposed (rows lane % 8 + 8 ((lane /
  // 8) % 2), chunk lane / 16).  Tiles start at multiples of 16 rows, so a
  // lane's swizzle depends on its own row offset alone.
  const int ra = lane & 15, ca_c = lane >> 4;
  const int rv = (lane & 7) + 8 * ((lane >> 3) & 1), cv_c = lane >> 4;
  const float* Sg = S + g * QS * QS;

  const int mtiles = QP / 16;
  for (int s = 0; s < 2 * ((mtiles + 2 * SM_WARPS - 1) / (2 * SM_WARPS));
       ++s) {
    // snake order: warp w takes tiles w, 2W-1-w, 2W+w, 4W-1-w, ...
    const int m = 2 * SM_WARPS * (s >> 1) +
                  ((s & 1) ? 2 * SM_WARPS - 1 - warp : warp);
    if (m >= mtiles) continue;
    const int i0 = 16 * m;

    // carry-in: acc = exp(cum_i) * (C_i . h_in)
    float acc[CP][4];
#pragma unroll
    for (int n = 0; n < CP; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[n][k] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NC; ++kc) {
      uint32_t ca[4];
      ldmatrix_x4(ca, Cs + (i0 + ra) * NP + swz<CN>(ra, 2 * kc + ca_c) * 8);
#pragma unroll
      for (int d2 = 0; d2 < PC; ++d2) {
        uint32_t hb[4];
        ldmatrix_x4_trans(
            hb, Hs + (16 * kc + rv) * PP + swz<CP>(rv, 2 * d2 + cv_c) * 8);
        mma_bf16(acc[2 * d2], ca, hb[0], hb[1]);
        mma_bf16(acc[2 * d2 + 1], ca, hb[2], hb[3]);
      }
    }
    const float ci[2] = {cs[i0 + gq], cs[i0 + gq + 8]};
    const float e[2] = {expf(ci[0]), expf(ci[1])};
#pragma unroll
    for (int n = 0; n < CP; ++n) {
      acc[n][0] *= e[0];
      acc[n][1] *= e[0];
      acc[n][2] *= e[1];
      acc[n][3] *= e[1];
    }

    // 16-key tiles on or below the diagonal; this lane's scores of a tile
    // are 4 pairs (rows i0 + gq and + 8, keys 8 nt + 2 tq and + 1), read
    // from S one tile ahead
    const float* srow = Sg + static_cast<long long>(i0 + gq) * QS + 2 * tq;
    float2 nxt[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        nxt[nt][h] = __ldg(reinterpret_cast<const float2*>(
            srow + 8 * h * QS + 8 * nt));
    for (int kt = 0; kt <= m; ++kt) {
      const int j0 = 16 * kt;
      float sc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sc[nt][2 * h] = nxt[nt][h].x;
          sc[nt][2 * h + 1] = nxt[nt][h].y;
        }
      if (kt < m) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            nxt[nt][h] = __ldg(reinterpret_cast<const float2*>(
                srow + 8 * h * QS + j0 + 16 + 8 * nt));
      }
      // the decay on the f32 scores; the causal mask on the diagonal tile
      // (masked entries are 0 without using the exp)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 cj =
            *reinterpret_cast<const float2*>(cs + j0 + 8 * nt + 2 * tq);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = i0 + gq + 8 * (k >> 1);
          const int j = j0 + 8 * nt + 2 * tq + (k & 1);
          const bool live = kt < m || j <= i;
          const float d = ci[k >> 1] - ((k & 1) ? cj.y : cj.x);
          sc[nt][k] = live ? sc[nt][k] * expf(d) : 0.f;
        }
      }
      // w rounded to bf16 as the A operand of w . xw_j
      uint32_t a[4];
      a[0] = pack_bf16(sc[0][0], sc[0][1]);
      a[1] = pack_bf16(sc[0][2], sc[0][3]);
      a[2] = pack_bf16(sc[1][0], sc[1][1]);
      a[3] = pack_bf16(sc[1][2], sc[1][3]);
#pragma unroll
      for (int d2 = 0; d2 < PC; ++d2) {
        uint32_t xv[4];
        ldmatrix_x4_trans(
            xv, Xs + (j0 + rv) * PP + swz<CP>(rv, 2 * d2 + cv_c) * 8);
        mma_bf16(acc[2 * d2], a, xv[0], xv[1]);
        mma_bf16(acc[2 * d2 + 1], a, xv[2], xv[3]);
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + gq + 8 * h;
      if (i >= Q) continue;
      bf16* orow = out + (r * Q + i) * P;
#pragma unroll
      for (int n = 0; n < CP; ++n) {
        const int c = 8 * n + 2 * tq;
        if (P % 2 == 0) {  // the pair is in range and 4-byte aligned
          if (c < P)
            *reinterpret_cast<__nv_bfloat162*>(orow + c) =
                __floats2bfloat162_rn(acc[n][2 * h], acc[n][2 * h + 1]);
        } else {
          if (c < P) orow[c] = __float2bfloat16(acc[n][2 * h]);
          if (c + 1 < P) orow[c + 1] = __float2bfloat16(acc[n][2 * h + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 (and bf16 chunks too long for shared memory): CUDA cores
// ---------------------------------------------------------------------------

static size_t ssd_smem_floats(int N) {
  return 2 * static_cast<size_t>(N) * SSD_LD  // C_i^T, B_j^T
         + SSD_T * SSD_LD                      // w^T
         + SSD_T * SSD_PT                      // xw_j
         + static_cast<size_t>(N) * SSD_PT     // h_in
         + 2 * SSD_T;                          // cum_i, cum_j
}

template <typename T>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_ffma_kernel(const T* __restrict__ cb, const T* __restrict__ bb,
                 const T* __restrict__ xw, const float* __restrict__ cum,
                 const T* __restrict__ hin, T* __restrict__ out, int Q, int N,
                 int P, int heads) {
  extern __shared__ float4 smem4[];
  float* Ct = reinterpret_cast<float*>(smem4);  // [N][SSD_LD]
  float* Bt = Ct + N * SSD_LD;                  // [N][SSD_LD]
  float* Wt = Bt + N * SSD_LD;                  // [SSD_T][SSD_LD]: w^T
  float* Xs = Wt + SSD_T * SSD_LD;              // [SSD_T][SSD_PT]
  float* Hs = Xs + SSD_T * SSD_PT;              // [N][SSD_PT]
  float* ci = Hs + N * SSD_PT;                  // [SSD_T]
  float* cj = ci + SSD_T;                       // [SSD_T]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // 16 x 16 threads, 4 x 4 each
  const long long r = blockIdx.x;
  const long long g = r / heads;
  const T* cbr = cb + g * Q * N;
  const T* bbr = bb + g * Q * N;
  const T* xwr = xw + r * Q * P;
  const float* cumr = cum + r * Q;
  const T* hr = hin + r * N * P;
  T* outr = out + r * Q * P;

  for (int idx = tid; idx < N * SSD_PT; idx += SSD_THREADS) {
    const int n = idx / SSD_PT, p = idx % SSD_PT;
    Hs[idx] = p < P ? to_f32(hr[n * P + p]) : 0.f;
  }

  for (int i0 = 0; i0 < Q; i0 += SSD_T) {
    __syncthreads();  // the previous query tile is done with Ct and ci
    for (int idx = tid; idx < SSD_T * N; idx += SSD_THREADS) {
      const int i = idx / N, n = idx % N;
      Ct[n * SSD_LD + i] = i0 + i < Q ? to_f32(cbr[(i0 + i) * N + n]) : 0.f;
    }
    for (int i = tid; i < SSD_T; i += SSD_THREADS)
      ci[i] = i0 + i < Q ? cumr[i0 + i] : 0.f;
    __syncthreads();

    // carry-in: acc = exp(cum_i) * (C_i . h_in)
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
    for (int n = 0; n < N; ++n) {
      const float4 ca = *reinterpret_cast<const float4*>(Ct + n * SSD_LD +
                                                         ty * 4);
      const float4 hb = *reinterpret_cast<const float4*>(Hs + n * SSD_PT +
                                                         tx * 4);
      const float av[4] = {ca.x, ca.y, ca.z, ca.w};
      const float bv[4] = {hb.x, hb.y, hb.z, hb.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float e = expf(ci[ty * 4 + a]);
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] *= e;
    }

    // key tiles on or below the diagonal
    for (int j0 = 0; j0 <= i0 && j0 < Q; j0 += SSD_T) {
      __syncthreads();  // everyone is done reading Bt, Xs, Wt, cj
      for (int idx = tid; idx < SSD_T * N; idx += SSD_THREADS) {
        const int j = idx / N, n = idx % N;
        Bt[n * SSD_LD + j] = j0 + j < Q ? to_f32(bbr[(j0 + j) * N + n]) : 0.f;
      }
      for (int idx = tid; idx < SSD_T * SSD_PT; idx += SSD_THREADS) {
        const int j = idx / SSD_PT, p = idx % SSD_PT;
        Xs[idx] = (j0 + j < Q && p < P) ? to_f32(xwr[(j0 + j) * P + p]) : 0.f;
      }
      for (int j = tid; j < SSD_T; j += SSD_THREADS)
        cj[j] = j0 + j < Q ? cumr[j0 + j] : 0.f;
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float4 ca = *reinterpret_cast<const float4*>(Ct + n * SSD_LD +
                                                           ty * 4);
        const float4 bj = *reinterpret_cast<const float4*>(Bt + n * SSD_LD +
                                                           tx * 4);
        const float av[4] = {ca.x, ca.y, ca.z, ca.w};
        const float bv[4] = {bj.x, bj.y, bj.z, bj.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) s[a][b] = fmaf(av[a], bv[b], s[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty * 4 + a;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = tx * 4 + b;
          const bool live = j0 + j <= i0 + i && j0 + j < Q;
          const float w = live ? s[a][b] * expf(ci[i] - cj[j]) : 0.f;
          Wt[j * SSD_LD + i] = round_to(w, xw);
        }
      }
      __syncthreads();

      for (int j = 0; j < SSD_T; ++j) {
        const float4 wa = *reinterpret_cast<const float4*>(Wt + j * SSD_LD +
                                                           ty * 4);
        const float4 xb = *reinterpret_cast<const float4*>(Xs + j * SSD_PT +
                                                           tx * 4);
        const float av[4] = {wa.x, wa.y, wa.z, wa.w};
        const float bv[4] = {xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
      }
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty * 4 + a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int p = tx * 4 + b;
        if (i < Q && p < P) store_t(outr + static_cast<long long>(i) * P + p,
                                    acc[a][b]);
      }
    }
  }
}

// the mma instantiations: N and P in 16-column chunks; a size between two
// takes the next larger
#define SSD_MMA_SHAPES(X)                                              \
  X(1, 1) X(1, 2) X(1, 4) X(2, 1) X(2, 2) X(2, 4) X(4, 1) X(4, 2) X(4, 4) \
  X(8, 1) X(8, 2) X(8, 4)

// Opt every kernel into the shared memory its largest launch needs, once,
// before any launch: the first call happens eagerly, so a later launch
// inside a CUDA-graph capture makes no attribute call.
static cudaError_t ensure_smem_attrs() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = allow_dynamic_smem(
      ssd_ffma_kernel<float>, ssd_smem_floats(SSD_MAX_N) * sizeof(float));
  if (e == cudaSuccess)
    e = allow_dynamic_smem(ssd_scores_kernel, ssd_scores_smem(SSD_MAX_N));
  if (e == cudaSuccess)
    e = allow_dynamic_smem(ssd_ffma_kernel<__nv_bfloat16>,
                           ssd_smem_floats(SSD_MAX_N) * sizeof(float));
#define SSD_OPT_MMA(NC, PC)                                            \
  if (e == cudaSuccess)                                                \
    e = allow_dynamic_smem(ssd_mma_kernel<NC, PC>, SM_SMEM_MAX);
  SSD_MMA_SHAPES(SSD_OPT_MMA)
#undef SSD_OPT_MMA
  done = e == cudaSuccess;
  return e;
}

template <typename T>
static cudaError_t launch_ffma(const void* cb, const void* bb, const void* xw,
                               const void* cum, const void* hin, void* out,
                               int R, int Q, int N, int P, int heads,
                               cudaStream_t stream) {
  const size_t smem = ssd_smem_floats(N) * sizeof(float);
  ssd_ffma_kernel<T><<<R, SSD_THREADS, smem, stream>>>(
      static_cast<const T*>(cb), static_cast<const T*>(bb),
      static_cast<const T*>(xw), static_cast<const float*>(cum),
      static_cast<const T*>(hin), static_cast<T*>(out), Q, N, P, heads);
  return cudaGetLastError();
}

static int round_chunks(int n, int most) {  // 16-column chunks, 1 2 4 8
  const int c = (n + 15) / 16;
  int p = 1;
  while (p < c && p < most) p *= 2;
  return p;
}

// The bf16 launch: the scores of every group, then the mma kernel, where
// the row's chunk fits a block's shared memory; else the FFMA kernel
// (chosen by shape).
static cudaError_t launch_bf16(const void* cb, const void* bb, const void* xw,
                               const void* cum, const void* hin, void* out,
                               void* scores, int R, int Q, int N, int P,
                               int heads, cudaStream_t stream) {
  const int nc = round_chunks(N, 8), pc = round_chunks(P, 4);
  const size_t smem = ssd_mma_smem(Q, nc, pc);
  if (smem > SM_SMEM_MAX)
    return launch_ffma<__nv_bfloat16>(cb, bb, xw, cum, hin, out, R, Q, N, P,
                                      heads, stream);
  const int QS = (Q + SC_T - 1) / SC_T * SC_T, T = QS / SC_T;
  const dim3 sgrid(T * (T + 1) / 2, R / heads);
  ssd_scores_kernel<<<sgrid, 256, ssd_scores_smem(N), stream>>>(
      static_cast<const bf16*>(cb), static_cast<const bf16*>(bb),
      static_cast<float*>(scores), Q, N, QS);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int vec_n = N % 8 == 0 && reinterpret_cast<uintptr_t>(cb) % 16 == 0;
  const int vec_p = P % 8 == 0 && reinterpret_cast<uintptr_t>(xw) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(hin) % 16 == 0;
#define SSD_LAUNCH_MMA(NC, PC)                                               \
  if (nc == NC && pc == PC) {                                                \
    ssd_mma_kernel<NC, PC><<<R, SM_THREADS, smem, stream>>>(                 \
        static_cast<const bf16*>(cb), static_cast<const float*>(scores),     \
        static_cast<const bf16*>(xw), static_cast<const float*>(cum),        \
        static_cast<const bf16*>(hin), static_cast<bf16*>(out), Q, N, P,     \
        heads, QS, vec_n, vec_p);                                            \
    return cudaGetLastError();                                               \
  }
  SSD_MMA_SHAPES(SSD_LAUNCH_MMA)
#undef SSD_LAUNCH_MMA
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (cb, bb, xw, h_in and out share it;
// cum is float32).  R = rows of xw / cum / h_in / out; cb and bb hold
// R / heads rows.  scores: f32 scratch of (R / heads) * QS * QS elements,
// QS = Q rounded up to 64, for bf16 (unused for f32).
extern "C" int ssd_chunk(const void* cb, const void* bb, const void* xw,
                         const void* cum, const void* hin, void* out,
                         void* scores, int R, int Q, int N, int P, int heads,
                         int dtype, void* stream) {
  if (Q < 1 || N < 1 || N > SSD_MAX_N || P < 1 || P > SSD_PT || heads < 1 ||
      R % heads != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t e = ensure_smem_attrs();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_ffma<float>(cb, bb, xw, cum, hin, out, R,
                                               Q, N, P, heads, st));
  return static_cast<int>(launch_bf16(cb, bb, xw, cum, hin, out, scores, R,
                                      Q, N, P, heads, st));
}
