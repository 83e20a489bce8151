// PTX wrappers for the bfloat16 tensor-core kernels on Hopper (sm_90a):
// asynchronous 16-byte copies into shared memory, ldmatrix and the
// m16n8k16 bfloat16 mma with float32 accumulators.  Included by
// flash_attention.cu and moe_gmm.cu.
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

namespace mma_bf16 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global `src` to shared `dst` without passing through
// registers; when !valid nothing is read and the 16 bytes are zero-filled
// (src-size 0).  Both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// Closes the group of this thread's copies issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

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
