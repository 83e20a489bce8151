// PTX wrapper for the int8 tensor-core GEMM on Hopper (sm_90a): the
// m16n8k32 s8 x s8 -> s32 mma, and how ldmatrix (ptx_copy.cuh, with the
// cp.async copies) fills its fragments.  Included by int8_matmul.cu.
//
// Fragment layouts of mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32
// (lane = 4 * g + t, g = lane / 4 in 0..7, t = lane % 4 in 0..3); a
// 32-bit register holds four int8 values, the lowest byte first:
//   A (16 x 32, row-major, k contiguous), four registers:
//     a[0] = A[g][4t .. 4t+3]          a[1] = A[g+8][4t .. 4t+3]
//     a[2] = A[g][16+4t .. 16+4t+3]    a[3] = A[g+8][16+4t .. 16+4t+3]
//   B (32 x 8, k x n, "col": each column's k values contiguous), two:
//     b[0] = B[4t .. 4t+3][g]          b[1] = B[16+4t .. 16+4t+3][g]
//   C and D (16 x 8, int32), four registers:
//     c[0], c[1] = C[g][2t, 2t+1]      c[2], c[3] = C[g+8][2t, 2t+1]
//
// ldmatrix (register i of lane (4g + t) gets bytes 4t .. 4t+3 of row g of
// matrix i) fills these fragments so:
//   * A from a row-major tile (rows of the tile = rows of A, k
//     contiguous): .x4 with lane l pointing at row l % 16, byte
//     16 * (l / 16) of the 16 x 32 block -> a[0..3];
//   * B from an n-major tile (rows = output columns, k contiguous: the
//     packed weight bt): .x2 with lane l pointing at row l % 8, byte
//     16 * ((l / 8) % 2) of the 8 x 32 block -> b[0], b[1] (lanes 16..31
//     repeat lanes 0..15: their addresses are read but not used).
// The int32 sums are exact, so the order of the k steps, of the mma's
// own adds and of a split over k never changes the result.
#pragma once

#include <stdint.h>

#include "ptx_copy.cuh"

namespace mma_s8 {

// d += A * B on the tensor cores: A 16 x 32 s8, B 32 x 8 s8, d int32.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace mma_s8
