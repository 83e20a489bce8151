// int8 x int8 -> int32 GEMM with one float32 rescale, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_int8_mm_kernel` in
// src/repro/kernels/int8_matmul.py (entry `int8_matmul`).
//
//   out[m, n] = __int2float_rn(sum_k a[m, k] * bt[n, k] + bias[n]) * scale
//
// a is (m, k) int8 row-major (activations, or the im2col patches of a
// convolution); bt is the weight prepacked offline to (n, ldb) int8,
// K-contiguous, ldb >= k and a multiple of 16, zero past k
// (`repro_torch.kernels.int8_matmul.pack_weight`).  bias is an optional
// (n,) int32 vector added to the integer sum before the scale, as the
// reference's int8 convolution adds its int32 bias before requantizing.
// The sum is exact in int32 and there is one float32 multiply, so the
// output equals the plain torch version bit for bit.
//
// What bounds it on this card.  The work is 2*m*n*k int8 operations and
// the bytes are m*k + n*k in and 4*m*n out.  At the main path's shapes
// (m from 1 to 12,544, k up to ~2,000, n up to a few hundred) the
// operations at the card's int8 tensor-core rate (1,979 TOP/s dense) take
// less time than the bytes at 3.35 TB/s, so the ideal kernel is bound by
// bytes; this first kernel uses __dp4a on the CUDA cores (no tensor
// cores), whose rate is far lower, so in practice it is bound by its
// integer throughput and, at m = 1, by latency.
//
// Design.
//  * Output tiles of 64 x 64 per block of 256 threads; each thread owns a
//    4 x 4 micro-tile of int32 accumulators.
//  * K loop in steps of 32 bytes: A and B tiles are staged in shared
//    memory as 32-bit words of 4 consecutive K values ([word][row], padded
//    against bank conflicts), then each thread issues 4 x 4 __dp4a per
//    word from two 16-byte shared loads.
//  * Any m, n and k: loads are predicated and zero-filled at the ragged
//    edges (the Pallas kernel asserts divisibility instead).  A word is
//    one aligned 4-byte load when the row stride and base allow it, else
//    four byte loads.
//  * Epilogue: int32 bias add, then __int2float_rn and __fmul_rn (round to
//    nearest even, no contraction), written as float32.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry point returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;              // rows of A per block
constexpr int kBN = 64;              // rows of bt (output columns) per block
constexpr int kBK = 32;              // K values (bytes) per step
constexpr int kWords = kBK / 4;      // 32-bit words per row and step
constexpr int kPad = 4;              // words of padding per shared row
constexpr int kThreads = 256;
static_assert(kBM == kBN, "the staging loop fills A and B rows together");
static_assert(kBM * kBN == kThreads * 16, "4 x 4 outputs per thread");

// The word of 4 consecutive int8 values of `row` starting at column `kb`
// (kb is a multiple of 4), zero outside [0, rows) x [0, k).
__device__ __forceinline__ int load_word(const int8_t* __restrict__ p, int row,
                                         int rows, int kb, int k, long long ld,
                                         bool vec) {
  if (row >= rows || kb >= k) return 0;
  const int8_t* src = p + row * ld + kb;
  if (vec && kb + 4 <= k) return __ldg(reinterpret_cast<const int*>(src));
  unsigned w = 0;
  for (int q = 0; q < 4 && kb + q < k; ++q) {
    w |= static_cast<unsigned>(static_cast<unsigned char>(__ldg(src + q)))
         << (8 * q);
  }
  return static_cast<int>(w);
}

__global__ void __launch_bounds__(kThreads) int8_gemm(
    const int8_t* __restrict__ a, const int8_t* __restrict__ bt,
    const int* __restrict__ bias, float* __restrict__ out, int m, int n, int k,
    int ldb, float scale) {
  __shared__ __align__(16) int as[kWords][kBM + kPad];
  __shared__ __align__(16) int bs[kWords][kBN + kPad];
  const int tid = threadIdx.x;
  const int tx = tid % 16;           // output columns n0 + 4*tx .. +3
  const int ty = tid / 16;           // output rows    m0 + 4*ty .. +3
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const bool a_vec =
      (k % 4 == 0) && (reinterpret_cast<uintptr_t>(a) % 4 == 0);
  const bool b_vec =
      (ldb % 4 == 0) && (reinterpret_cast<uintptr_t>(bt) % 4 == 0);

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // Consecutive threads take consecutive words of one row: coalesced.
    for (int w = tid; w < kBM * kWords; w += kThreads) {
      const int r = w / kWords;
      const int kw = w % kWords;
      as[kw][r] = load_word(a, m0 + r, m, k0 + 4 * kw, k, k, a_vec);
      bs[kw][r] = load_word(bt, n0 + r, n, k0 + 4 * kw, k, ldb, b_vec);
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kWords; ++kw) {
      const int4 av = *reinterpret_cast<const int4*>(&as[kw][4 * ty]);
      const int4 bv = *reinterpret_cast<const int4*>(&bs[kw][4 * tx]);
      const int ar[4] = {av.x, av.y, av.z, av.w};
      const int br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * ty + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 4 * tx + j;
      if (col >= n) continue;
      const int v = acc[i][j] + (bias != nullptr ? __ldg(bias + col) : 0);
      out[static_cast<long long>(row) * n + col] =
          __fmul_rn(__int2float_rn(v), scale);
    }
  }
}

}  // namespace

extern "C" int int8_matmul_launch(const void* a, const void* bt,
                                  const void* bias, void* out, int m, int n,
                                  int k, int ldb, float scale, void* stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  int8_gemm<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(bt),
      static_cast<const int*>(bias), static_cast<float*>(out), m, n, k, ldb,
      scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
