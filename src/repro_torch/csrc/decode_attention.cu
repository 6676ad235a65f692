// decode_attention: one query per row against its row of a KV cache,
// with a ragged valid length per row; split over the keys and shared by
// the query group.
//
//   s[r, j]  = (q[r] . k[b, j, kv]) * D^-0.5          for j < lengths[r]
//   p = exp(s - max s), summed in f32 into l, rounded to v's type,
//   out[r]   = (sum_j p_j v[b, j, kv]) / l
//   query row r = (b * KV + kv) * G + g, q (B*KV*G, D),
//   k/v (B, S, KV, D) — the model layout; the kernel layout (BKV, S, D)
//   is the case KV = 1 — lengths (B*KV*G,) int32 -> out (B*KV*G, D)
//   f32 or bf16 in, f32 accumulation, output in q's type
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention_pallas
// (body _decode_kernel): grid (BH, nk) with the KV axis sequential, the
// (m, l, acc) online-softmax state in VMEM scratch, 512-wide KV blocks,
// the lengths brought in by scalar prefetch, p rounded to v's type before
// p.v.
//
// What bounds it here: bytes.  Each cached key and value is needed once
// for the whole query group and used for 4 G FLOPs per element; at
// gemma_2b's G = 8 that is 8 FLOPs per bf16 byte, far below the ~295
// where the H100's tensor cores would become the limit.  At the serving
// shape in chip_smoke.py (gemma_2b geometry: 8 query heads on 1 KV head,
// D = 256, batch 128, 32k cache, bf16) the cache is 4.3 GB and the bound
// is ~1.3 ms at 3.35 TB/s.
//
// Design: one block of 4 warps per (KV row, key split, chunk of 16 query
// rows of the group), so each cached key and value is read from device
// memory once for up to 16 query heads (a group wider than 16 reads it
// once per 16).  The block reads its rows' lengths and streams only keys
// below the longest of them within its split, in tiles staged into
// shared memory by 16-byte cp.async copies through a 2-stage ring; keys
// past a row's own length weigh nothing, keys past the longest are never
// read, and a row of length 0 gives zeros.  Each warp takes its slice of
// every tile (16 keys in bf16, 8 in f32) and keeps its own (m, l, acc)
// for the 16 rows.  In bf16 the 16-row score tile and P.V are mma.sync
// products (the group padded to 16 rows with zero queries; at 8 FLOPs
// per byte either tensor cores or FFMA could keep up with the memory,
// and mma.sync costs the fewest instructions per byte, reusing the flash
// kernel's fragments), with P rounded to bf16 in registers; in f32 they
// are FFMA out of shared memory (TF32 would break the f32 parity).  The
// 4 warp states merge through shared memory at the end.  With one split
// the block writes the output; with several it writes its (m, l, acc) to
// f32 scratch that the caller allocates, and a second kernel merges the
// splits of each row in split order (no atomics: a fixed sum order).
// Masked scores use -1e30, not -inf, as the TPU kernel does.  Shared
// memory past 48 KB is opted into once, at the first launch.
#include "common.cuh"
#include "mma.cuh"

#include <cuda_bf16.h>
#include <math.h>

#define DA_WARPS 4
#define DA_ROWS 16  // query rows per block
#define DA_MAX_D 256
#define DA_NEG -1e30f
#define DA_LOG2E 1.4426950408889634f

template <typename T, int NDC>
struct DecodeShape {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int DP = 16 * NDC;                // padded head dim
  static constexpr int LD = DP + 16 / sizeof(T);     // 16-byte row pad
  static constexpr int KPW = BF16 ? 16 : 8;          // keys per warp
  static constexpr int BN = DA_WARPS * KPW;          // keys per tile
  static constexpr size_t QS = DA_ROWS * LD * sizeof(T);
  static constexpr size_t RING = 4 * BN * LD * sizeof(T);
  // the warps' (m, l, acc) for the end merge, over the ring
  static constexpr size_t MERGE =
      DA_WARPS * (DA_ROWS * DP + 2 * DA_ROWS) * sizeof(float);
  // f32 only: each warp's score tile and row corrections
  static constexpr size_t SCR =
      BF16 ? 0 : DA_WARPS * (DA_ROWS * (KPW + 1) + DA_ROWS) * sizeof(float);
  static constexpr size_t SMEM = QS + (RING > MERGE ? RING : MERGE) + SCR;
};

__device__ __forceinline__ void store_t(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_t(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// bf16: this warp's KPW = 16 keys of the tile against the 16 rows, on the
// tensor cores.  State: rows g and g + 8 of the mma layout.
template <int NDC>
__device__ __forceinline__ void warp_tile_bf16(
    const __nv_bfloat16* Qs, const __nv_bfloat16* Kt,
    const __nv_bfloat16* Vt, int key0, const int* s_hi, float scale_log2,
    float (&m)[2], float (&l)[2], float (&o)[2 * NDC][4]) {
  using Sh = DecodeShape<__nv_bfloat16, NDC>;
  constexpr int LD = Sh::LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const __nv_bfloat16* Kw = Kt + Sh::KPW * warp * LD;
  const __nv_bfloat16* Vw = Vt + Sh::KPW * warp * LD;
  const int k_ld = ((lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1);
  const int v_ld = ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
  const __nv_bfloat16* qa = Qs + (lane & 15) * LD + 8 * (lane >> 4);

  float s[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
  for (int kc = 0; kc < NDC; ++kc) {
    uint32_t a[4], bk[4];
    ldmatrix_x4(a, qa + 16 * kc);
    ldmatrix_x4(bk, Kw + k_ld + 16 * kc);
    mma_bf16(s[0], a, bk[0], bk[1]);
    mma_bf16(s[1], a, bk[2], bk[3]);
  }
  const int kw0 = key0 + Sh::KPW * warp;
  const int hi[2] = {s_hi[g], s_hi[g + 8]};
  bool ok[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ok[i][j] = kw0 + 8 * i + 2 * tq + (j & 1) < hi[j >> 1];
      s[i][j] = ok[i][j] ? s[i][j] * scale_log2 : DA_NEG;
    }
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      mx = fmaxf(mx, fmaxf(s[i][2 * h], s[i][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    corr[h] = fast_exp2(m[h] - mx);
    m[h] = mx;
    float ps = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 2 * h; j < 2 * h + 2; ++j) {
        s[i][j] = ok[i][j] ? fast_exp2(s[i][j] - mx) : 0.f;
        ps += s[i][j];
      }
    l[h] = l[h] * corr[h] + ps;  // this thread's columns; quad sum at end
  }
  uint32_t a[4];
  a[0] = pack_bf16(s[0][0], s[0][1]);
  a[1] = pack_bf16(s[0][2], s[0][3]);
  a[2] = pack_bf16(s[1][0], s[1][1]);
  a[3] = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
  for (int d2 = 0; d2 < NDC; ++d2) {
    uint32_t bv[4];
    ldmatrix_x4_trans(bv, Vw + v_ld + 16 * d2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[2 * d2][j] *= corr[j >> 1];
      o[2 * d2 + 1][j] *= corr[j >> 1];
    }
    mma_bf16(o[2 * d2], a, bv[0], bv[1]);
    mma_bf16(o[2 * d2 + 1], a, bv[2], bv[3]);
  }
}

// f32: this warp's KPW = 8 keys against the 16 rows, FFMA.  State: lane
// r < 16 holds row r's (m, l); lane c holds columns c, c + 32, ... of
// every row's accumulator.
template <int NDC, int NC>
__device__ __forceinline__ void warp_tile_f32(
    const float* Qs, const float* Kt, const float* Vt, int key0,
    const int* s_hi, float scale_log2, float* Sw, float& m, float& l,
    float (&acc)[DA_ROWS][NC]) {
  using Sh = DecodeShape<float, NDC>;
  constexpr int LD = Sh::LD, KPW = Sh::KPW, SLD = KPW + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* Cw = Sw + DA_ROWS * SLD;
  const int kw0 = key0 + KPW * warp;
  {  // scores: lane takes key j and rows rb, rb + 4, rb + 8, rb + 12
    const int j = lane % KPW, rb = lane / KPW;
    const float* kr = Kt + (KPW * warp + j) * LD;
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < Sh::DP; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qq =
            *reinterpret_cast<const float4*>(Qs + (rb + 4 * i) * LD + d);
        sc[i] = fmaf(qq.x, kk.x, sc[i]);
        sc[i] = fmaf(qq.y, kk.y, sc[i]);
        sc[i] = fmaf(qq.z, kk.z, sc[i]);
        sc[i] = fmaf(qq.w, kk.w, sc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rb + 4 * i;
      Sw[r * SLD + j] = kw0 + j < s_hi[r] ? sc[i] * scale_log2 : DA_NEG;
    }
  }
  __syncwarp();
  if (lane < DA_ROWS) {  // row bookkeeping: p overwrites the scores
    float* sr = Sw + lane * SLD;
    float mx = m;
#pragma unroll
    for (int j = 0; j < KPW; ++j) mx = fmaxf(mx, sr[j]);
    const float corr = fast_exp2(m - mx);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < KPW; ++j) {
      const float p = kw0 + j < s_hi[lane] ? fast_exp2(sr[j] - mx) : 0.f;
      sr[j] = p;
      ps += p;
    }
    l = l * corr + ps;
    m = mx;
    Cw[lane] = corr;
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < DA_ROWS; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] *= Cw[r];
#pragma unroll
  for (int j = 0; j < KPW; ++j) {
    const float* vr = Vt + (KPW * warp + j) * LD;
    float vv[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      vv[c] = d < Sh::DP ? vr[d] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < DA_ROWS; ++r) {
      const float p = Sw[r * SLD + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
    }
  }
  __syncwarp();  // Sw is read before the next tile overwrites it
}

template <typename T, int NDC>
__global__ void __launch_bounds__(DA_WARPS * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ out, float* __restrict__ part_ml,
                    float* __restrict__ part_acc, int S, int KV, int G, int D,
                    int splits, int chunk, float scale_log2, int vec) {
  using Sh = DecodeShape<T, NDC>;
  constexpr int LD = Sh::LD, BN = Sh::BN, DP = Sh::DP;
  constexpr int NC = (DP + 31) / 32;
  extern __shared__ __align__(16) unsigned char da_smem[];
  __shared__ int s_hi[DA_ROWS];
  T* Qs = reinterpret_cast<T*>(da_smem);
  T* Ks = reinterpret_cast<T*>(da_smem + Sh::QS);  // 2 stages of BN rows
  T* Vs = Ks + 2 * BN * LD;
  float* Mm = reinterpret_cast<float*>(da_smem + Sh::QS);  // after the loop
  float* Ml = Mm + DA_WARPS * DA_ROWS;
  float* Ma = Ml + DA_WARPS * DA_ROWS;
  float* Scr = reinterpret_cast<float*>(
      da_smem + Sh::QS + (Sh::RING > Sh::MERGE ? Sh::RING : Sh::MERGE));

  const int kvrow = blockIdx.x, split = blockIdx.y;
  const int b = kvrow / KV, kvh = kvrow - b * KV;
  const int row0 = kvrow * G + DA_ROWS * static_cast<int>(blockIdx.z);
  const int nr = min(DA_ROWS, kvrow * G + G - row0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long stride = static_cast<long long>(KV) * D;
  const long long kv_off = static_cast<long long>(b) * S * stride +
                           static_cast<long long>(kvh) * D;
  const int lo = split * chunk;
  const int end = min(S, lo + chunk);

  if (tid < DA_ROWS)
    s_hi[tid] = tid < nr ? min(max(lengths[row0 + tid], 0), end) : 0;
  __syncthreads();
  int hi = lo;
#pragma unroll
  for (int r = 0; r < DA_ROWS; ++r) hi = max(hi, s_hi[r]);
  const int ntiles = (hi - lo + BN - 1) / BN;

  stage_rows<T, DP>(Qs, LD, q + static_cast<long long>(row0) * D, D, nr,
                    DA_ROWS, D, vec, tid, DA_WARPS * 32);
  auto stage_kv = [&](int t, int st) {
    const int k0 = lo + t * BN;
    const long long off = kv_off + k0 * stride;
    stage_rows<T, DP>(Ks + st * BN * LD, LD, k + off, stride, hi - k0, BN, D,
                      vec, tid, DA_WARPS * 32);
    stage_rows<T, DP>(Vs + st * BN * LD, LD, v + off, stride, hi - k0, BN, D,
                      vec, tid, DA_WARPS * 32);
  };
  if (ntiles > 0) stage_kv(0, 0);
  cp_async_commit();

  // this warp's state for the block's 16 rows
  float m[2] = {DA_NEG, DA_NEG}, l[2] = {0.f, 0.f};
  float o[Sh::BF16 ? 2 * NDC : 1][4];
  float acc[Sh::BF16 ? 1 : DA_ROWS][Sh::BF16 ? 1 : NC];
#pragma unroll
  for (int i = 0; i < (Sh::BF16 ? 2 * NDC : 1); ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
#pragma unroll
  for (int r = 0; r < (Sh::BF16 ? 1 : DA_ROWS); ++r)
#pragma unroll
    for (int c = 0; c < (Sh::BF16 ? 1 : NC); ++c) acc[r][c] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t + 1 < ntiles) stage_kv(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* Kt = Ks + st * BN * LD;
    const T* Vt = Vs + st * BN * LD;
    if constexpr (Sh::BF16) {
      warp_tile_bf16<NDC>(Qs, Kt, Vt, lo + t * BN, s_hi, scale_log2, m, l,
                          o);
    } else {
      warp_tile_f32<NDC, NC>(
          Qs, Kt, Vt, lo + t * BN, s_hi, scale_log2,
          Scr + warp * (DA_ROWS * (Sh::KPW + 1) + DA_ROWS), m[0], l[0], acc);
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the merge area overlays it

  float* wa = Ma + warp * DA_ROWS * DP;
  if constexpr (Sh::BF16) {
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      if (tq == 0) {
        Mm[warp * DA_ROWS + g + 8 * h] = m[h];
        Ml[warp * DA_ROWS + g + 8 * h] = l[h];
      }
    }
#pragma unroll
    for (int i = 0; i < 2 * NDC; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wa[(g + 8 * (j >> 1)) * DP + 8 * i + 2 * tq + (j & 1)] = o[i][j];
  } else {
    if (lane < DA_ROWS) {
      Mm[warp * DA_ROWS + lane] = m[0];
      Ml[warp * DA_ROWS + lane] = l[0];
    }
#pragma unroll
    for (int r = 0; r < DA_ROWS; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < DP) wa[r * DP + d] = acc[r][c];
      }
  }
  __syncthreads();

  for (int e = tid; e < nr * D; e += DA_WARPS * 32) {
    const int r = e / D, d = e - r * D;
    float M = DA_NEG;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) M = fmaxf(M, Mm[w * DA_ROWS + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) {
      const float c = fast_exp2(Mm[w * DA_ROWS + r] - M);
      L = fmaf(Ml[w * DA_ROWS + r], c, L);
      A = fmaf(Ma[(w * DA_ROWS + r) * DP + d], c, A);
    }
    const long long row = row0 + r;
    if (splits == 1) {
      store_t(out + row * D + d, A / fmaxf(L, 1e-30f));
    } else {
      const long long ps = row * splits + split;
      part_acc[ps * D + d] = A;
      if (d == 0) {
        part_ml[2 * ps] = M;
        part_ml[2 * ps + 1] = L;
      }
    }
  }
}

// out[r] = sum_s acc_s exp2(m_s - M) / sum_s l_s exp2(m_s - M), M the
// largest m_s, the splits summed in order
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ part_ml,
                                    const float* __restrict__ part_acc,
                                    T* __restrict__ out, int splits, int D) {
  const long long row = blockIdx.x;
  const float* ml = part_ml + row * splits * 2;
  float M = DA_NEG;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, ml[2 * s]);
  float L = 0.f;
  for (int s = 0; s < splits; ++s) L = fmaf(ml[2 * s + 1],
                                            fast_exp2(ml[2 * s] - M), L);
  const float inv = 1.f / fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float* a = part_acc + row * splits * D + d;
    float A = 0.f;
    for (int s = 0; s < splits; ++s)
      A = fmaf(a[static_cast<long long>(s) * D], fast_exp2(ml[2 * s] - M), A);
    store_t(out + row * D + d, A * inv);
  }
}

#define DA_CHUNKS(X) X(1) X(2) X(4) X(5) X(6) X(8) X(12) X(16)

static cudaError_t ensure_smem_attrs() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaSuccess;
#define DA_OPT(N)                                                        \
  if (e == cudaSuccess)                                                  \
    e = allow_dynamic_smem(decode_split_kernel<float, N>,                \
                           DecodeShape<float, N>::SMEM);                 \
  if (e == cudaSuccess)                                                  \
    e = allow_dynamic_smem(decode_split_kernel<__nv_bfloat16, N>,        \
                           DecodeShape<__nv_bfloat16, N>::SMEM);
  DA_CHUNKS(DA_OPT)
#undef DA_OPT
  done = e == cudaSuccess;
  return e;
}

template <typename T>
static cudaError_t launch_decode(const void* q, const void* k, const void* v,
                                 const void* lengths, void* out,
                                 void* part_ml, void* part_acc, int B, int S,
                                 int KV, int G, int D, int splits, int chunk,
                                 cudaStream_t stream) {
  const float scale_log2 =
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))) * DA_LOG2E;
  const bool vec = (D * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const dim3 grid(B * KV, splits, (G + DA_ROWS - 1) / DA_ROWS);
  const int nc = (D + 15) / 16;
  bool launched = false;
#define DA_LAUNCH(N)                                                        \
  if (!launched && nc <= N) {                                               \
    decode_split_kernel<T, N>                                               \
        <<<grid, DA_WARPS * 32, DecodeShape<T, N>::SMEM, stream>>>(         \
            static_cast<const T*>(q), static_cast<const T*>(k),             \
            static_cast<const T*>(v), static_cast<const int*>(lengths),     \
            static_cast<T*>(out), static_cast<float*>(part_ml),             \
            static_cast<float*>(part_acc), S, KV, G, D, splits, chunk,      \
            scale_log2, vec ? 1 : 0);                                       \
    launched = true;                                                        \
  }
  DA_CHUNKS(DA_LAUNCH)
#undef DA_LAUNCH
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  decode_merge_kernel<T><<<B * KV * G, 128, 0, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<T*>(out), splits, D);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  The cache
// is (B, S, KV, D); split s reads keys [s * chunk, (s + 1) * chunk).  With
// splits > 1, part_ml (B*KV*G, splits, 2) and part_acc (B*KV*G, splits,
// D) are f32 scratch; with one split they are not touched.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, void* part_ml,
                                void* part_acc, int B, int S, int KV, int G,
                                int D, int splits, int chunk, int dtype,
                                void* stream) {
  if (D < 1 || D > DA_MAX_D || KV < 1 || G < 1 || S < 0 || splits < 1 ||
      splits > 65535 || chunk < 1 ||
      static_cast<long long>(splits) * chunk < S ||
      (G + DA_ROWS - 1) / DA_ROWS > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t e = ensure_smem_attrs();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_decode<float>(
        q, k, v, lengths, out, part_ml, part_acc, B, S, KV, G, D, splits,
        chunk, st));
  return static_cast<int>(launch_decode<__nv_bfloat16>(
      q, k, v, lengths, out, part_ml, part_acc, B, S, KV, G, D, splits, chunk,
      st));
}
