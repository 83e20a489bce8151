// PTX wrappers for moving data into and out of shared memory on Hopper
// (sm_90a): asynchronous copies from global memory and ldmatrix.  Shared
// by the tensor-core headers (mma_bf16.cuh, mma_s8.cuh) and by
// winograd_conv.cu.
//
// ldmatrix reads 8 x 8 matrices of 16-bit values, i.e. 8 rows of 16
// bytes: lanes 8i .. 8i+7 give the addresses of the eight rows of matrix
// i, and register i of lane (4g + t) receives bytes 4t .. 4t+3 of row g
// of matrix i (with .trans: column g, rows 2t and 2t+1).  The mma headers
// write out which fragment each form fills for their types.
#pragma once

#include <stdint.h>

namespace ptx {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes to shared `dst` without passing through registers: the first
// `src_bytes` (0..16) are read from global `src`, the rest zero-filled.
// Both addresses must be 16-byte aligned; with src_bytes == 0 nothing is
// read.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}
// A flag would convert to a byte count of 1: pass 16 or 0.
__device__ void cp_async_16(void*, const void*, bool) = delete;

// 4 bytes, as cp_async_16; both addresses 4-byte aligned.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ void cp_async_4(void*, const void*, bool) = delete;

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

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

}  // namespace ptx
