// Winograd F(2x2, 3x3) convolution tiles on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_winograd_kernel` in
// src/repro/kernels/winograd_conv.py (entry `winograd_conv2d`).
//
//   tiles (T, 16, C) f32 : overlapping 4x4 input tiles, extracted in torch
//                          (`repro_torch.kernels.ref.extract_winograd_tiles`)
//   u     (16, C, K) f32 : pre-transformed weights U = G g G^T, made once
//                          when the op is built
//   y     (T, 4, K)  f32 : 2x2 output tiles, assembled in torch
//
// For every tile t and output channel q:
//   V_e[t, c] = (B^T d_tc B)_e           (adds only: B has entries 0, +-1)
//   M_e[t, q] = sum_c V_e[t, c] U_e[c, q]   for the 16 positions e
//   y[t, :, q] = A^T M[t, q] A           (adds only)
//
// What bounds it on this card.  The work is 2*16*T*C*K float32 operations
// (the 16 products) plus a few adds per element for the transforms; the
// bytes are 64*T*C + 64*C*K in and 16*T*K out.  At the study's shapes (C, K
// from 64 to 256) one tile's 64*C input bytes feed 32*C*K operations, far
// above the card's float32 ratio (67 TFLOP/s over 3.35 TB/s, 20 operations
// a byte), so the ideal kernel is bound by float32 operations.  The
// shapes are small (1.6-2.3 us of work at the peak), so the kernel's real
// limits are how many of the 132 SMs it keeps busy and how many shared
// loads each FMA costs.
//
// Design: two launches (a run of them on a large input, below).
//  * Pass 1, `winograd_products`: the 16 positions are 16 independent
//    products M_e = V_e U_e, so blockIdx.z is the position and each block
//    owns BT tiles x BQ output channels of one position: 16 times the
//    blocks of a kernel that keeps all positions of a tile in one block.
//    A block transforms only its own position's V from the 4 entries of d
//    it needs (one row pair and one column pair of B^T), and writes M_e
//    to a (16, T, K) float32 workspace from registers, 16 bytes a store
//    where K is a multiple of 4.  (Staging M through shared memory for
//    row-wise stores was slower on the card.)  Tile blocks go on
//    blockIdx.x (up to 2^31 - 1 of them), channel blocks on blockIdx.y.
//  * Register blocking: each thread computes a 4 x 4 (tile x channel)
//    outer product per input channel from two 16-byte shared loads, 16
//    FMAs per two loads.
//  * The C loop walks chunks of CC (16 or 32) channels through a 2-slot
//    ring: the U chunk goes by cp.async (16-byte copies when K is a
//    multiple of 4, else 4-byte ones); the 4 d entries of each (tile,
//    channel) of the next chunk are loaded into registers before the
//    current chunk's products and transformed into V after them.  One
//    barrier a chunk.
//  * The block tile (BT x BQ = 16 x 128 or 16 x 64) and CC are chosen
//    per shape by `winograd_conv_cuda.plan`.  Every block of a position
//    and tile range reads the same d entries, so a BQ that covers K reads
//    them once (the NAS op's K = 77).
//  * Pass 2, `winograd_output`: one thread per (tile, output channel)
//    reads its 16 M values and applies A^T M A.
//  * The C entry runs both passes on runs of at most `t_pass` tiles,
//    which the plan sizes so that the workspace holds at most 32 MiB
//    (it stays in the 50 MB L2) and which reuse that one workspace.  The
//    study shapes are one run each, with at most 3.9 MB of workspace.
//  * Any T, C and K: loads are predicated and zero-filled, stores masked
//    (the Pallas kernel asserts k % block_k == 0 instead).
//  * Full float32: fmaf accumulation, no TF32, no fast math, no atomics:
//    every output is summed in a fixed order, so two launches on the same
//    inputs agree bit for bit.  Only the order of the float32 sums
//    differs from the plain version.
//
// The kernels allocate nothing and launch on the caller's stream and
// card (host_launch.cuh's DeviceGuard); the C
// entry point returns cudaGetLastError() of its launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx_copy.cuh"
#include "host_launch.cuh"

namespace {

constexpr int kOutThreads = 256;     // pass 2

// Row i of B^T is d[a1] + s * d[a2] along one axis of the 4 x 4 tile:
//   (d0 - d2, d1 + d2, d2 - d1, d1 - d3).
__constant__ int kA1[4] = {0, 1, 2, 1};
__constant__ int kA2[4] = {2, 2, 1, 3};
__constant__ float kSgn[4] = {-1.f, 1.f, -1.f, -1.f};

template <int BT, int BQ, int CC>
__global__ void __launch_bounds__(BT * BQ / 16) winograd_products(
    const float* __restrict__ tiles, const float* __restrict__ u,
    float* __restrict__ mws, int t_total, int c, int k) {
  constexpr int kThreads = BT * BQ / 16;
  constexpr int kPairs = BT * CC / kThreads;    // (tile, channel) pairs a thread
  static_assert(BT * CC % kThreads == 0 && CC % 4 == 0, "whole pairs per thread");
  // V rows padded by 4: a thread's transformed (tile, channel) pairs go
  // down a column, and the pad spreads them over the banks.
  constexpr int kV = 2 * CC * (BT + 4), kU = 2 * CC * BQ;
  __shared__ __align__(16) float smem[kV + kU];
  auto vs = reinterpret_cast<float (*)[CC][BT + 4]>(smem);
  auto us = reinterpret_cast<float (*)[CC][BQ]>(smem + kV);

  const int tid = threadIdx.x;
  const int tt = tid % (BT / 4);     // tiles t0 + 4*tt .. +3
  const int qq = tid / (BT / 4);     // channels q0 + 4*qq .. +3
  const int t0 = blockIdx.x * BT;
  const int q0 = blockIdx.y * BQ;
  const int e = blockIdx.z;          // position (i, j) = (e / 4, e % 4)
  const int i = e / 4, j = e % 4;
  // The four entries of d this position reads, at 4*row + column:
  // V_e = (d[a1i][a1j] + si d[a2i][a1j]) + sj (d[a1i][a2j] + si d[a2i][a2j]).
  const int d11 = 4 * kA1[i] + kA1[j], d21 = 4 * kA2[i] + kA1[j];
  const int d12 = 4 * kA1[i] + kA2[j], d22 = 4 * kA2[i] + kA2[j];
  const float si = kSgn[i], sj = kSgn[j];
  const int nchunks = (c + CC - 1) / CC;
  const float* u_e = u + static_cast<long long>(e) * c * k;
  const bool u_vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0;

  float d[kPairs][4];
  auto fetch_d = [&](int c0) {       // the next chunk's d entries
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int w = tid + p * kThreads;
      const int t = t0 + w / CC;
      const int ch = c0 + w % CC;    // consecutive threads: consecutive channels
      if (t < t_total && ch < c) {
        const float* src = tiles + static_cast<long long>(t) * 16 * c + ch;
        d[p][0] = __ldg(src + d11 * c);
        d[p][1] = __ldg(src + d21 * c);
        d[p][2] = __ldg(src + d12 * c);
        d[p][3] = __ldg(src + d22 * c);
      } else {
        d[p][0] = d[p][1] = d[p][2] = d[p][3] = 0.f;
      }
    }
  };
  auto store_v = [&](int slot) {     // (B^T d B)_e: rows first, then columns
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int w = tid + p * kThreads;
      const float r1 = d[p][0] + si * d[p][1];
      const float r2 = d[p][2] + si * d[p][3];
      vs[slot][w % CC][w / CC] = r1 + sj * r2;
    }
  };
  auto copy_u = [&](int slot, int c0) {  // consecutive threads: consecutive channels
    if (u_vec) {
      for (int w = tid; w < CC * BQ / 4; w += kThreads) {
        const int lc = w / (BQ / 4), lq = 4 * (w % (BQ / 4));
        const bool ok = c0 + lc < c && q0 + lq < k;
        ptx::cp_async_16(&us[slot][lc][lq],
                         ok ? u_e + static_cast<long long>(c0 + lc) * k + q0 + lq : u_e,
                         ok ? 16 : 0);
      }
    } else {
      for (int w = tid; w < CC * BQ; w += kThreads) {
        const int lc = w / BQ, lq = w % BQ;
        const bool ok = c0 + lc < c && q0 + lq < k;
        ptx::cp_async_4(&us[slot][lc][lq],
                        ok ? u_e + static_cast<long long>(c0 + lc) * k + q0 + lq : u_e,
                        ok ? 4 : 0);
      }
    }
    ptx::cp_async_commit();
  };

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  copy_u(0, 0);
  fetch_d(0);
  store_v(0);
  for (int ch = 0; ch < nchunks; ++ch) {
    ptx::cp_async_wait<0>();
    __syncthreads();                 // chunk ch in both slots; slot ch+1 free
    const int slot = ch % 2;
    const bool more = ch + 1 < nchunks;
    if (more) {
      copy_u(slot ^ 1, (ch + 1) * CC);
      fetch_d((ch + 1) * CC);
    }
#pragma unroll
    for (int lc = 0; lc < CC; ++lc) {
      const float4 v = *reinterpret_cast<const float4*>(&vs[slot][lc][4 * tt]);
      const float4 w = *reinterpret_cast<const float4*>(&us[slot][lc][4 * qq]);
      const float vr[4] = {v.x, v.y, v.z, v.w};
      const float wr[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(vr[a], wr[b], acc[a][b]);
    }
    if (more) store_v(slot ^ 1);
  }
  ptx::cp_async_wait<0>();           // nothing in flight at exit (c == 0)

  float* dst = mws + static_cast<long long>(e) * t_total * k;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int t = t0 + 4 * tt + a;
    if (t >= t_total) continue;
    const int q = q0 + 4 * qq;
    float* row = dst + static_cast<long long>(t) * k + q;
    if (k % 4 == 0 && q + 3 < k) {
      *reinterpret_cast<float4*>(row) = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      continue;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (q + b < k) row[b] = acc[a][b];
  }
}

__global__ void __launch_bounds__(kOutThreads) winograd_output(
    const float* __restrict__ mws, float* __restrict__ y, int t_total, int k) {
  const long long idx = static_cast<long long>(blockIdx.x) * kOutThreads + threadIdx.x;
  const long long tk = static_cast<long long>(t_total) * k;
  if (idx >= tk) return;
  const int t = static_cast<int>(idx / k);
  const int q = static_cast<int>(idx % k);
  float m[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) m[e] = __ldg(mws + e * tk + idx);
  float r0[4], r1[4];                // A^T M: rows
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r0[j] = m[j] + m[4 + j] + m[8 + j];
    r1[j] = m[4 + j] - m[8 + j] - m[12 + j];
  }
  float* dst = y + static_cast<long long>(t) * 4 * k + q;
  dst[0] = r0[0] + r0[1] + r0[2];            // (A^T M) A: columns
  dst[k] = r0[1] - r0[2] - r0[3];
  dst[2 * k] = r1[0] + r1[1] + r1[2];
  dst[3 * k] = r1[1] - r1[2] - r1[3];
}

template <int BT, int BQ, int CC>
void launch_products(const float* tiles, const float* u, float* mws, int t_total,
                     int c, int k, cudaStream_t s) {
  const dim3 grid((t_total + BT - 1) / BT, (k + BQ - 1) / BQ, 16);
  winograd_products<BT, BQ, CC><<<grid, BT * BQ / 16, 0, s>>>(tiles, u, mws, t_total, c, k);
}

}  // namespace

// bt x bq is a block tile and cc a chunk depth of `TILE_SET`; `mws` holds
// 16 * min(t_total, t_pass) * k float32.  The two passes run on each run
// of t_pass tiles in turn: 2 * ceil(t_total / t_pass) launches.
extern "C" int winograd_conv_launch(const void* tiles, const void* u, void* y,
                                    void* mws, int t_total, int t_pass, int c,
                                    int k, int bt, int bq, int cc, int device,
                                    void* stream) {
  const host_launch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  void (*products)(const float*, const float*, float*, int, int, int, cudaStream_t);
#define TILE_SET(BT, BQ, CC)                                          \
  if (bt == BT && bq == BQ && cc == CC) {                             \
    products = launch_products<BT, BQ, CC>;                           \
  } else
  TILE_SET(16, 128, 16) TILE_SET(16, 128, 32) TILE_SET(16, 64, 16)
  TILE_SET(16, 64, 32)
  return static_cast<int>(cudaErrorInvalidValue);
#undef TILE_SET
  if (t_pass <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mp = static_cast<float*>(mws);
  for (long long t0 = 0; t0 < t_total; t0 += t_pass) {
    const int n = static_cast<int>(t_total - t0 < t_pass ? t_total - t0 : t_pass);
    products(static_cast<const float*>(tiles) + t0 * 16 * c,
             static_cast<const float*>(u), mp, n, c, k, s);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tk = static_cast<long long>(n) * k;
    winograd_output<<<static_cast<unsigned>((tk + kOutThreads - 1) / kOutThreads),
                      kOutThreads, 0, s>>>(mp, static_cast<float*>(y) + t0 * 4 * k, n, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

extern "C" const char* winograd_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
