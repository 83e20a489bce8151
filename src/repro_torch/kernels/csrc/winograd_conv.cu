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
// a byte), so the ideal kernel is bound by float32 operations; this first
// kernel is bound by its shared-memory reads (two 8-byte loads per four
// FMAs).
//
// Design.
//  * A block owns 32 tiles x 32 output channels; each of its 256 threads
//    owns 2 tiles x 2 channels and keeps all 16 positions of each in
//    registers (64 float32 accumulators), so the output transform needs no
//    second pass.
//  * The C loop walks chunks of 8 channels: each thread loads one (tile,
//    channel) 4x4 patch (channels fastest: coalesced), applies B^T d B in
//    registers and stores V position-major in shared memory; the U chunk
//    is staged beside it (output channels fastest: coalesced).
//  * Any T, C and K: loads are predicated and zero-filled, stores masked
//    (the Pallas kernel asserts k % block_k == 0 instead).
//  * Full float32: fmaf accumulation, no TF32, no fast math.  Only the
//    order of the float32 sums differs from the plain version.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry point returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kBT = 32;              // tiles per block
constexpr int kBQ = 32;              // output channels per block
constexpr int kCC = 8;               // input channels per C step
constexpr int kThreads = 256;
static_assert(kBT * kCC == kThreads, "one (tile, channel) patch per thread");
static_assert((kBT / 2) * (kBQ / 2) == kThreads, "2 x 2 outputs per thread");

__global__ void __launch_bounds__(kThreads) winograd_f2x3(
    const float* __restrict__ tiles, const float* __restrict__ u,
    float* __restrict__ y, int t_total, int c, int k) {
  __shared__ __align__(16) float vs[16][kCC][kBT];
  __shared__ __align__(16) float us[16][kCC][kBQ];
  const int tid = threadIdx.x;
  const int tt = tid / (kBQ / 2);    // tiles t0 + 2*tt, +1
  const int qq = tid % (kBQ / 2);    // channels q0 + 2*qq, +1
  const int t0 = blockIdx.x * kBT;
  const int q0 = blockIdx.y * kBQ;

  float acc[2][2][16];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[a][b][e] = 0.f;

  for (int c0 = 0; c0 < c; c0 += kCC) {
    {  // Input transform of one (tile, channel) patch.
      const int lt = tid / kCC;
      const int lc = tid % kCC;
      const int t = t0 + lt;
      const int ch = c0 + lc;
      float d[16];
      if (t < t_total && ch < c) {
        const float* src = tiles + static_cast<long long>(t) * 16 * c + ch;
#pragma unroll
        for (int e = 0; e < 16; ++e) d[e] = __ldg(src + static_cast<long long>(e) * c);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) d[e] = 0.f;
      }
      float r[4][4];                 // B^T d: rows of the tile
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r[0][j] = d[j] - d[8 + j];
        r[1][j] = d[4 + j] + d[8 + j];
        r[2][j] = d[8 + j] - d[4 + j];
        r[3][j] = d[4 + j] - d[12 + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // (B^T d) B: columns
        vs[4 * i + 0][lc][lt] = r[i][0] - r[i][2];
        vs[4 * i + 1][lc][lt] = r[i][1] + r[i][2];
        vs[4 * i + 2][lc][lt] = r[i][2] - r[i][1];
        vs[4 * i + 3][lc][lt] = r[i][1] - r[i][3];
      }
    }
    for (int w = tid; w < 16 * kCC * kBQ; w += kThreads) {
      const int e = w / (kCC * kBQ);
      const int lc = (w / kBQ) % kCC;
      const int lq = w % kBQ;
      const int ch = c0 + lc;
      const int q = q0 + lq;
      us[e][lc][lq] = (ch < c && q < k)
          ? __ldg(u + (static_cast<long long>(e) * c + ch) * k + q) : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int lc = 0; lc < kCC; ++lc) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float2 v = *reinterpret_cast<const float2*>(&vs[e][lc][2 * tt]);
        const float2 w = *reinterpret_cast<const float2*>(&us[e][lc][2 * qq]);
        acc[0][0][e] = fmaf(v.x, w.x, acc[0][0][e]);
        acc[0][1][e] = fmaf(v.x, w.y, acc[0][1][e]);
        acc[1][0][e] = fmaf(v.y, w.x, acc[1][0][e]);
        acc[1][1][e] = fmaf(v.y, w.y, acc[1][1][e]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int t = t0 + 2 * tt + a;
      const int q = q0 + 2 * qq + b;
      if (t >= t_total || q >= k) continue;
      const float* m = acc[a][b];
      float r0[4], r1[4];            // A^T M: rows
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
  }
}

}  // namespace

extern "C" int winograd_conv_launch(const void* tiles, const void* u, void* y,
                                    int t_total, int c, int k, void* stream) {
  const dim3 grid((t_total + kBT - 1) / kBT, (k + kBQ - 1) / kBQ);
  winograd_f2x3<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tiles), static_cast<const float*>(u),
      static_cast<float*>(y), t_total, c, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* winograd_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
