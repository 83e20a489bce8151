// int8 x int8 -> int32 GEMM with one float32 rescale, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_int8_mm_kernel` in
// src/repro/kernels/int8_matmul.py (entry `int8_matmul`).
//
//   out[m, n] = __int2float_rn(sum_k a[m, k] * bt[n, k] + bias[n]) * scale
//
// a is (m, k) int8 with row stride lda >= k (activations, or the im2col
// patches of a convolution, whose rows the executor pads to 16 bytes); bt
// is the weight prepacked offline to (n, ldb) int8, K-contiguous, ldb a
// multiple of 16 (`repro_torch.kernels.int8_matmul.pack_weight`).  bias is
// an optional (n,) int32 vector added to the integer sum before the scale,
// as the reference's int8 convolution adds its int32 bias before
// requantizing.  The sum is exact in int32 and there is one float32
// multiply, so the output equals the plain torch version bit for bit.
//
// What bounds it on this card.  The work is 2*m*n*k int8 operations and
// the bytes are m*k + n*k in and 4*m*n out.  At the main path's shapes (m
// from 1 to 12,544, k from 3 to 1,580, n up to 1,580) the operations at
// the int8 tensor-core rate (1,979 TOP/s dense) take less time than the
// bytes at 3.35 TB/s, so the ideal kernel is bound by bytes; every one of
// these GEMMs moves under 2 MB, so in practice each is bound by latency:
// how many SMs it keeps busy and how long one block's k loop runs.
//
// Design.
//  * Products on the s8 tensor cores: mma.sync m16n8k32 (mma_s8.cuh),
//    fragments read by ldmatrix from shared rows of 48 bytes (32 of k and
//    16 of padding, so the eight rows of one ldmatrix phase fall on eight
//    different 16-byte bank groups).  4 warps a block.
//  * Two block tiles (BM x BN = 64 x 32 and 16 x 32, the ones the plan
//    picks at the main path's shapes) and a split of k over blockIdx.z,
//    chosen per shape by `int8_matmul_cuda.plan` so that small-m and
//    small-n shapes still launch at least one block per SM where k
//    allows.  The output tiles are numbered along blockIdx.x (up to
//    2^31 - 1 of them), column tile fastest, so m and n have no practical
//    limit and neighbouring blocks share rows of A.
//  * A 4-stage ring of 32-byte k steps, one barrier a step.  bt, and A
//    when its rows and base are 16-byte aligned, go through 16-byte
//    cp.async with the tail past k zero-filled by the copy itself.  Any
//    other A is read as aligned 4-byte words (two funnel-shifted into one
//    when lda or the base is not a multiple of 4) into registers: the
//    prologue's three steps all at once, then one step ahead, stored
//    after that step's products.  It still feeds the tensor cores.
//  * Split k: the 2-8 splits of an output tile run as one thread-block
//    cluster along blockIdx.z.  Each block leaves its int32 partial sums
//    in its own shared memory; after a cluster barrier, rank 0 adds the
//    others' through distributed shared memory and finishes the tile
//    (bias and scale once, after the whole sum).  No workspace, no
//    atomics, nothing to zero; integer sums are exact in any order.  One
//    launch a call, whatever the route.
//  * Epilogue: int32 bias add, then __int2float_rn and __fmul_rn (round
//    to nearest even, no contraction), stored from the fragments, two
//    adjacent columns as one float2 where n is even.  (Staging the tile
//    through shared memory for row-wise stores was slower on the card.)
//
// The kernel allocates nothing and launches on the caller's stream and
// card (host_launch.cuh's DeviceGuard); the C
// entry point returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include "mma_s8.cuh"
#include "host_launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBK = 32;              // k bytes per stage: one mma depth
constexpr int kRow = 48;             // shared row stride in bytes
constexpr int kStages = 4;
constexpr int kThreads = 128;

struct Params {
  const int8_t* a;
  const int8_t* bt;
  const int* bias;                   // may be null
  float* out;
  int m, n, k, lda, ldb;
  int k_split;                       // k bytes per split, a multiple of kBK
  int splits;                        // blocks of a cluster along z, at most 8
  int a_async;                       // A rows and base 16-byte aligned
  float scale;
};

__device__ __forceinline__ float rescale(int v, const int* bias, int col,
                                         float scale) {
  if (bias != nullptr) v += __ldg(bias + col);
  return __fmul_rn(__int2float_rn(v), scale);
}

template <int BM, int BN, int WARPS_M, bool A_ASYNC>
__global__ void __launch_bounds__(kThreads) int8_gemm_mma(const Params p) {
  constexpr int WARPS_N = kThreads / 32 / WARPS_M;
  constexpr int WM = BM / WARPS_M;   // rows of a warp's tile
  constexpr int WN = BN / WARPS_N;   // columns of a warp's tile
  constexpr int MF = WM / 16;        // m16 fragments a warp
  constexpr int NF = WN / 8;         // n8 fragments a warp
  static_assert(WM % 16 == 0 && WN % 8 == 0, "warp tile of whole fragments");
  constexpr int A_WORDS = BM * kBK / 4;
  constexpr int A_WPT = (A_WORDS + kThreads - 1) / kThreads;

  // The A and B rings; with k split, the same bytes then hold this
  // block's int32 partial sums for the cluster's reduction.
  constexpr int kRing = kStages * (BM + BN) * kRow;
  constexpr int kAcc = MF * NF * 4;  // accumulators a thread
  static_assert(kAcc * kThreads * 4 <= kRing, "the partial tile fits the ring");
  __shared__ __align__(16) int8_t smem[kRing];
  auto as = reinterpret_cast<int8_t (*)[BM][kRow]>(smem);
  auto bs = reinterpret_cast<int8_t (*)[BN][kRow]>(smem + kStages * BM * kRow);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wm = (tid / 32) / WARPS_N;
  const int wn = (tid / 32) % WARPS_N;
  const int n_tiles = (p.n + BN - 1) / BN;
  const int m0 = static_cast<int>(blockIdx.x / n_tiles) * BM;
  const int n0 = static_cast<int>(blockIdx.x % n_tiles) * BN;
  const int kb = blockIdx.z * p.k_split;
  const int ke = min(p.k, kb + p.k_split);
  const int nk = ke > kb ? (ke - kb + kBK - 1) / kBK : 0;
  const bool a_vec4 = (p.lda % 4 == 0) &&
                      (reinterpret_cast<uintptr_t>(p.a) % 4 == 0);

  // 16-byte chunks of `rows` rows of a K-contiguous operand, the bytes
  // past ke zero-filled.
  auto copy_tile = [&](int8_t (*dst)[kRow], const int8_t* src, int r0,
                       int rows, int ld, int nrows, int k0) {
    for (int c = tid; c < nrows * 2; c += kThreads) {
      const int r = c / 2;
      const int kc = k0 + 16 * (c % 2);
      const int row = r0 + r;
      const int bytes = row < rows ? max(0, min(16, ke - kc)) : 0;
      const int8_t* s = bytes > 0 ? src + static_cast<long long>(row) * ld + kc : src;
      ptx::cp_async_16(&dst[r][16 * (c % 2)], s, bytes);
    }
  };
  // Unaligned A goes through registers: the prologue's stages are all
  // loaded before any is stored, then the loop loads one step ahead.
  int pre[kStages - 1][A_WPT];
  auto fetch_a = [&](int (&buf)[A_WPT], int k0) {
#pragma unroll
    for (int i = 0; i < A_WPT; ++i) {
      const int w = tid + i * kThreads;
      const int row = m0 + w / 8;
      const int kc = k0 + 4 * (w % 8);
      unsigned v = 0;
      if (w < A_WORDS && row < p.m && kc < ke) {
        // The aligned word holding the first byte, and when the four bytes
        // straddle two words (lda or the base not a multiple of 4) the
        // next one too, if it holds a byte before ke.  Bytes past ke meet
        // the zeros cp.async wrote into B.
        const uintptr_t o = reinterpret_cast<uintptr_t>(p.a) +
                            static_cast<uintptr_t>(row) * p.lda + kc;
        const unsigned* al = reinterpret_cast<const unsigned*>(o & ~uintptr_t{3});
        if (a_vec4) {
          v = __ldg(al);
        } else {
          const int sh = static_cast<int>(o & 3);
          const unsigned lo = __ldg(al);
          const unsigned hi = sh != 0 && kc + 4 - sh < ke ? __ldg(al + 1) : 0u;
          v = __funnelshift_r(lo, hi, 8 * sh);
        }
      }
      buf[i] = static_cast<int>(v);
    }
  };
  auto store_a = [&](const int (&buf)[A_WPT], int slot) {
#pragma unroll
    for (int i = 0; i < A_WPT; ++i) {
      const int w = tid + i * kThreads;
      if (w < A_WORDS) *reinterpret_cast<int*>(&as[slot][w / 8][4 * (w % 8)]) = buf[i];
    }
  };
  auto load_stage = [&](int slot, int k0, int (&buf)[A_WPT]) {
    copy_tile(bs[slot], p.bt, n0, p.n, p.ldb, BN, k0);
    if constexpr (A_ASYNC) copy_tile(as[slot], p.a, m0, p.m, p.lda, BM, k0);
    else fetch_a(buf, k0);
  };

  int acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, kb + s * kBK, pre[s]);
    ptx::cp_async_commit();
  }
  if constexpr (!A_ASYNC) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s)
      if (s < nk) store_a(pre[s], s);
  }
  for (int kt = 0; kt < nk; ++kt) {
    ptx::cp_async_wait<kStages - 2>();
    __syncthreads();                 // step kt landed; slot (kt-1) is free
    const int pf = kt + kStages - 1;
    if (pf < nk) load_stage(pf % kStages, kb + pf * kBK, pre[0]);
    ptx::cp_async_commit();

    const int slot = kt % kStages;
    uint32_t af[MF][4];
    uint32_t bf[NF][2];
#pragma unroll
    for (int i = 0; i < MF; ++i)
      ptx::ldmatrix_x4(af[i], &as[slot][wm * WM + 16 * i + lane % 16][16 * (lane / 16)]);
#pragma unroll
    for (int j = 0; j < NF; ++j)
      ptx::ldmatrix_x2(bf[j], &bs[slot][wn * WN + 8 * j + lane % 8][16 * ((lane / 8) % 2)]);
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j) mma_s8::mma_s8_16832(acc[i][j], af[i], bf[j]);
    if (pf < nk && !A_ASYNC) store_a(pre[0], pf % kStages);
  }

  // Accumulator (i, j, q) holds row g (+8 for q >= 2), column 2t + q % 2
  // of fragment (i, j).
  const int g = lane / 4;
  const int t = lane % 4;
  auto row_of = [&](int i, int q) { return m0 + wm * WM + 16 * i + g + 8 * (q / 2); };
  auto col_of = [&](int j, int q) { return n0 + wn * WN + 8 * j + 2 * t + q % 2; };
  if (p.splits > 1) {
    // Split k: the splits of a tile are one cluster (blockIdx.z is the
    // rank).  Each block leaves its partial sums in its shared memory;
    // rank 0 adds the others' over distributed shared memory, in rank
    // order, and finishes the tile.
    cg::cluster_group cluster = cg::this_cluster();
    int* part = reinterpret_cast<int*>(smem);
    ptx::cp_async_wait<0>();
    __syncthreads();                 // every warp is done with the ring
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[((i * NF + j) * 4 + q) * kThreads + tid] = acc[i][j][q];
    cluster.sync();
    const bool first = cluster.block_rank() == 0;
    if (first) {
      for (int r = 1; r < p.splits; ++r) {
        const int* other = cluster.map_shared_rank(part, r);
#pragma unroll
        for (int i = 0; i < MF; ++i)
#pragma unroll
          for (int j = 0; j < NF; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j][q] += other[((i * NF + j) * 4 + q) * kThreads + tid];
      }
    }
    cluster.sync();                  // the others' partials stay until read
    if (!first) return;
  }

  // Bias, scale, store: two adjacent columns as one float2 where aligned.
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int h = 0; h < 4; h += 2) {
        const int row = row_of(i, h), col = col_of(j, h);
        if (row >= p.m) continue;
        float* dst = p.out + static_cast<long long>(row) * p.n + col;
        if (p.n % 2 == 0 && col + 1 < p.n) {
          *reinterpret_cast<float2*>(dst) =
              make_float2(rescale(acc[i][j][h], p.bias, col, p.scale),
                          rescale(acc[i][j][h + 1], p.bias, col + 1, p.scale));
        } else {
          if (col < p.n) dst[0] = rescale(acc[i][j][h], p.bias, col, p.scale);
          if (col + 1 < p.n) dst[1] = rescale(acc[i][j][h + 1], p.bias, col + 1, p.scale);
        }
      }
}

template <int BM, int BN, int WARPS_M, bool A_ASYNC>
cudaError_t launch_as(const Params& p, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((p.m + BM - 1) / BM) * ((p.n + BN - 1) / BN), 1, p.splits);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = p.splits;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int8_gemm_mma<BM, BN, WARPS_M, A_ASYNC>, p);
}

template <int BM, int BN, int WARPS_M>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  return p.a_async ? launch_as<BM, BN, WARPS_M, true>(p, stream)
                   : launch_as<BM, BN, WARPS_M, false>(p, stream);
}

}  // namespace

// bm x bn is one of the two block tiles; k_split a multiple of 32 with
// splits = ceil(k / k_split) <= 8 (one cluster a tile).  a_async: lda and
// a are multiples of 16 bytes.
extern "C" int int8_matmul_launch(const void* a, const void* bt,
                                  const void* bias, void* out, int m, int n,
                                  int k, int lda, int ldb, int bm, int bn,
                                  int k_split, int splits, int a_async,
                                  float scale, int device, void* stream) {
  const host_launch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (k_split <= 0 || k_split % kBK != 0 || splits < 1 || splits > 8 ||
      static_cast<long long>(k_split) * (splits - 1) >= (k > 0 ? k : 1) ||
      ldb % 16 != 0 || (a_async && lda % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const int8_t*>(a), static_cast<const int8_t*>(bt),
                 static_cast<const int*>(bias), static_cast<float*>(out),
                 m, n, k, lda, ldb, k_split, splits, a_async, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bm == 64 && bn == 32) err = launch<64, 32, 4>(p, s);
  else if (bm == 16 && bn == 32) err = launch<16, 32, 1>(p, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
