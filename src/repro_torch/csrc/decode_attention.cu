// decode_attention: one query per row against its row of a KV cache,
// with a ragged valid length per row.
//
//   s[b, j]  = (q[b] . k[b / G, j]) * D^-0.5          for j < lengths[b]
//   out[b]   = sum_j softmax(s[b])_j * v[b / G, j]
//   q (BH, D), k/v (BKV, S, D), lengths (BH,) int32 -> out (BH, D)
//   BH = BKV * G (GQA: G query rows share one KV row, never repeated)
//   f32 or bf16 in, f32 accumulation, output in q's type
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention_pallas
// (body _decode_kernel): grid (BH, nk) with the KV axis sequential, the
// (m, l, acc) online-softmax state in VMEM scratch, 512-wide KV blocks and
// the lengths brought in by scalar prefetch.
//
// What bounds it here: bytes.  Every cached key and value is read once
// per query row and used for 2 FLOPs per element, far below the ~295
// FLOPs per byte where the H100's bf16 tensor cores would become the
// limit.  At the serving shape in chip_smoke.py (gemma_2b geometry: 8
// query heads on 1 KV head, D = 256, batch 128, 32k cache, bf16) the
// cache is 4.3 GB and the bound is ~1.3 ms at 3.35 TB/s.
//
// Design: one block of 8 warps per query row; the loop inside the block
// takes the place of the TPU's sequential KV grid axis.  The block reads
// its own length (no scalar prefetch) and streams only the first
// lengths[row] keys: warp w takes key groups w, w + 8, ... of 4 keys, so
// the block sweeps the row front to back.  Lane l owns head elements
// l, l + 32, ... (coalesced loads), a key's dot product is a lane partial
// sum closed by warp shuffles, and each warp keeps its own running max,
// sum and accumulator in registers.  The 8 warp states merge through
// shared memory at the end.  The G query rows of one KV row are adjacent
// blocks, so they stream the same KV row at about the same time and
// mostly share it through L2.  Keys past a row's length are never read;
// a row of length 0 gives zeros.  Masked scores use -1e30, not -inf, as
// the TPU kernel does.
#include "common.cuh"

#include <cuda_bf16.h>
#include <math.h>

#define DA_WARPS 8
#define DA_UNROLL 4
#define DA_MAX_D 256
#define DA_NEG -1e30f

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// NJ = head elements per lane: D <= 32 * NJ
template <typename T, int NJ>
__global__ void __launch_bounds__(DA_WARPS * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int S, int D, int q_per_kv, float scale) {
  __shared__ float sm_m[DA_WARPS];
  __shared__ float sm_l[DA_WARPS];
  __shared__ float sm_acc[DA_WARPS][DA_MAX_D];
  const int row = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = min(max(lengths[row], 0), S);
  const long long kv_off = static_cast<long long>(row / q_per_kv) * S * D;
  const T* kr = k + kv_off;
  const T* vr = v + kv_off;

  float qv[NJ], acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int d = lane + 32 * j;
    qv[j] = d < D ? load_f32(q + static_cast<long long>(row) * D + d) : 0.f;
    acc[j] = 0.f;
  }
  float m = DA_NEG, l = 0.f;

  for (int s0 = warp * DA_UNROLL; s0 < n; s0 += DA_WARPS * DA_UNROLL) {
    float sc[DA_UNROLL];
    float vv[DA_UNROLL][NJ];
#pragma unroll
    for (int u = 0; u < DA_UNROLL; ++u) {
      const int s = s0 + u;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane + 32 * j;
        vv[u][j] = 0.f;
        if (s < n && d < D) {
          const long long e = static_cast<long long>(s) * D + d;
          part = fmaf(qv[j], load_f32(kr + e), part);
          vv[u][j] = load_f32(vr + e);
        }
      }
      sc[u] = part;
    }
#pragma unroll
    for (int u = 0; u < DA_UNROLL; ++u)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], off);
    float mx = m;
#pragma unroll
    for (int u = 0; u < DA_UNROLL; ++u) {
      sc[u] = (s0 + u < n) ? sc[u] * scale : DA_NEG;
      mx = fmaxf(mx, sc[u]);
    }
    const float corr = expf(m - mx);
    l *= corr;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] *= corr;
#pragma unroll
    for (int u = 0; u < DA_UNROLL; ++u) {
      const float p = (s0 + u < n) ? expf(sc[u] - mx) : 0.f;
      l += p;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j] = fmaf(p, vv[u][j], acc[j]);
    }
    m = mx;
  }

  // merge the 8 warp states: rescale each to the block's max
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int d = lane + 32 * j;
    if (d < D) sm_acc[warp][d] = acc[j];
  }
  __syncthreads();
  float M = DA_NEG;
#pragma unroll
  for (int w = 0; w < DA_WARPS; ++w) M = fmaxf(M, sm_m[w]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) {
      const float c = expf(sm_m[w] - M);
      L = fmaf(sm_l[w], c, L);
      A = fmaf(sm_acc[w][d], c, A);
    }
    store_f32(out + static_cast<long long>(row) * D + d, A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int NJ>
static cudaError_t launch_decode(const void* q, const void* k, const void* v,
                                 const void* lengths, void* out, int BH,
                                 int S, int D, int q_per_kv,
                                 cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  decode_attention_kernel<T, NJ><<<BH, DA_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), S, D, q_per_kv, scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_decode(const void* q, const void* k, const void* v,
                                   const void* lengths, void* out, int BH,
                                   int S, int D, int q_per_kv,
                                   cudaStream_t stream) {
  const int nj = (D + 31) / 32;
  if (nj <= 1)
    return launch_decode<T, 1>(q, k, v, lengths, out, BH, S, D, q_per_kv,
                               stream);
  if (nj <= 2)
    return launch_decode<T, 2>(q, k, v, lengths, out, BH, S, D, q_per_kv,
                               stream);
  if (nj <= 4)
    return launch_decode<T, 4>(q, k, v, lengths, out, BH, S, D, q_per_kv,
                               stream);
  return launch_decode<T, 8>(q, k, v, lengths, out, BH, S, D, q_per_kv,
                             stream);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it)
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, int BH, int S,
                                int D, int q_per_kv, int dtype,
                                void* stream) {
  if (D < 1 || D > DA_MAX_D || q_per_kv < 1 || BH % q_per_kv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(dispatch_decode<float>(q, k, v, lengths, out, BH,
                                                   S, D, q_per_kv, st));
  if (dtype == 1)
    return static_cast<int>(dispatch_decode<__nv_bfloat16>(
        q, k, v, lengths, out, BH, S, D, q_per_kv, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
