// Tensor-core and async-copy helpers shared by the attention, SSD-chunk
// and rank-space kernels.
//
// Warp-level bf16 products on the tensor cores (mma.sync.m16n8k16, f32
// accumulation), their operands read from shared memory with ldmatrix,
// and cp.async copies (16 and 4 bytes) of row tiles from device memory
// into shared memory (stage_rows, stage_f32).
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4), in 32-bit
// registers of two bf16 (the lower half holds the smaller column):
//   A (16 x 16, row-major):  a0 (g, 2t..2t+1)    a1 (g+8, 2t..2t+1)
//                            a2 (g, 2t+8..2t+9)  a3 (g+8, 2t+8..2t+9)
//   B (16 x 8, k x n):       b0 (k 2t..2t+1, n g) b1 (k 2t+8..2t+9, n g)
//   C (16 x 8, f32):         c0 c1 (g, 2t..2t+1)  c2 c3 (g+8, 2t..2t+1)
// So the C fragments of two adjacent 8-column tiles, rounded to bf16 in
// pairs, are the A fragment of a 16-deep product (the attention kernels
// feed P to P.V this way, without a trip through shared memory).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy from device to shared memory; with !valid nothing is read
// and the 16 bytes are zero-filled (src must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
// 4-byte copy, the same way
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8, and register j receives matrix j in the mma fragment layout
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// the same, each matrix transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b  (16x16 bf16 times 16x8 bf16, f32 accumulators)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (max relative error ~2^-22; flushes
// subnormal results to 0, so 2^-1e30 is 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 rounded to bf16 (to nearest even) in one register, lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage `nrows` rows of a tile into shared memory (row stride `ld`
// elements): element (r, c) for c < DP is src[r * stride + c] where
// r < valid_rows and c < D, else 0.  With `vec` (D * sizeof(T) and the
// source 16-byte aligned) the copies are cp.async of 16 bytes, the
// caller commits and waits; otherwise plain loads and stores.
template <typename T, int DP>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           long long stride, int valid_rows,
                                           int nrows, int D, bool vec,
                                           int tid, int nthreads) {
  if (vec) {
    constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
    constexpr int CH = DP / EPC;
    for (int e = tid; e < nrows * CH; e += nthreads) {
      const int r = e / CH;
      const int c = (e - r * CH) * EPC;
      T* d = dst + r * ld + c;
      if (c < D) {
        const int rs = r < valid_rows ? r : 0;
        cp_async16(d, src + rs * stride + c, r < valid_rows);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      }
    }
  } else {
    for (int e = tid; e < nrows * DP; e += nthreads) {
      const int r = e / DP;
      const int c = e - r * DP;
      dst[r * ld + c] = (r < valid_rows && c < D)
                            ? src[r * stride + c]
                            : static_cast<T>(0.f);
    }
  }
}

// Copy a rows x cols f32 matrix (source row stride `stride` floats) into
// shared memory rows of `ld` floats (ld % 4 == 0, ld >= cols), zero-filling
// columns cols..ld-1: 16-byte cp.async copies when every source row starts
// on 16 bytes and cols % 4 == 0, 4-byte ones otherwise; the caller commits
// and waits.  Called by every thread of the block.  The rank-space kernels
// (conv_rank, rank_apply, compose_apply) stage this way: their tiles are
// all in range, and staging them through stage_rows (its bound on the
// valid rows, its width at run time) read slower on the H100 at their
// path shapes, where a call takes a few microseconds (PERF.md section 6).
__device__ __forceinline__ void stage_f32(float* dst, int ld, const float* src,
                                          long long stride, int rows,
                                          int cols) {
  if (cols % 4 == 0 && stride % 4 == 0 && aligned16(src)) {
    const int c4 = ld / 4;
    for (int e = threadIdx.x; e < rows * c4; e += blockDim.x) {
      const int r = e / c4;
      const int c = (e - r * c4) * 4;
      const float* s = src + r * stride;
      cp_async16(dst + r * ld + c, c < cols ? s + c : s, c < cols);
    }
  } else {
    for (int e = threadIdx.x; e < rows * ld; e += blockDim.x) {
      const int r = e / ld;
      const int c = e - r * ld;
      const float* s = src + r * stride;
      cp_async4(dst + r * ld + c, c < cols ? s + c : s, c < cols);
    }
  }
}
