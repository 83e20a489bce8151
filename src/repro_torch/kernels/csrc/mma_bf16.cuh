// PTX wrappers for the bfloat16 tensor-core kernels on Hopper (sm_90a):
// the m16n8k16 bfloat16 mma with float32 accumulators, and how ldmatrix
// (ptx_copy.cuh, with the cp.async copies) fills its fragments.  Included
// by flash_attention.cu and moe_gmm.cu.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// (lane = 4 * g + t, g = lane / 4 in 0..7, t = lane % 4 in 0..3):
//   A (16 x 16, row-major), four 32-bit registers of two bf16 each:
//     a[0] = A[g][2t, 2t+1]      a[1] = A[g+8][2t, 2t+1]
//     a[2] = A[g][2t+8, 2t+9]    a[3] = A[g+8][2t+8, 2t+9]
//   B (16 x 8, k x n), two registers:
//     b[0] = B[2t, 2t+1][g]      b[1] = B[2t+8, 2t+9][g]
//   C and D (16 x 8, float32), four registers:
//     c[0], c[1] = C[g][2t, 2t+1]    c[2], c[3] = C[g+8][2t, 2t+1]
// The lower half of a packed register holds the element with the smaller
// column (A) or k (B) index.
//
// ldmatrix .x4 reads four 8 x 8 bf16 matrices from shared memory: lanes
// 8i .. 8i+7 give the addresses of the eight 16-byte rows of matrix i,
// and register i of lane (4g + t) receives matrix i's row g, columns 2t
// and 2t+1; with .trans it receives column g, rows 2t and 2t+1.  So
//   * A from a row-major tile: lane l points at row l % 16, column
//     8 * (l / 16) of the 16 x 16 block -> a[0..3];
//   * B from an n-major tile (B's columns are rows in memory, k
//     contiguous: K in Q.K^T): lane l points at row n0 + l % 8 + 8 * (l / 16),
//     column k0 + 8 * ((l / 8) % 2) -> b[0], b[1] of n-block n0 and
//     b[0], b[1] of n-block n0 + 8;
//   * B from a k-major tile (n contiguous: V in P.V, w in x.w) with .trans:
//     lane l points at row k0 + l % 16, column n0 + 8 * (l / 16) -> the
//     same four registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "ptx_copy.cuh"

namespace mma_bf16 {

// d += A * B on the tensor cores: A 16 x 16 bf16, B 16 x 8 bf16, d float32.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two float32 values rounded to bf16 (nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace mma_bf16
