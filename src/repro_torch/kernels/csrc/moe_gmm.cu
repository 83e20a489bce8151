// Grouped expert matmul (MoE GMM) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_gmm_kernel` in
// src/repro/kernels/moe_gmm.py (entry `moe_gmm`).
//
//   out[e, c, f] = sum_d x[e, c, d] * w[e, d, f]
//
// x is (E, C, Dm), w (E, Dm, F), out (E, C, F), all contiguous and all
// float32 or all bfloat16; products are summed in float32 and the output is
// rounded once to the input type, as the Pallas kernel's f32 VMEM
// accumulator is.  The serving path folds the batch into the rows
// (C = batch * capacity), since the expert weights are shared across it.
//
// What bounds it on this card.  The bytes are the weights, E*Dm*F
// elements, plus x and out; the operations are 2*E*C*Dm*F.  At decode
// (E = 32, C = 4 * 8, Dm = 1024, F = 512, bfloat16) the weights are 33.6 MB
// a launch and each 2-byte weight takes part in 2*C = 64 operations, 32 a
// byte, far below the ~295 a byte the tensor cores need: bound by bytes,
// 11 us at 3.35 TB/s.  At prefill (C = 4 * 320) the two are close: 48 us
// for the bytes of x, w and the output, 43 us for the operations at
// 989 TFLOP/s bf16.  This first kernel multiplies on the CUDA cores in
// float32 (67 TFLOP/s peak), so prefill sits far above that floor; at
// decode most of its rows are the empty capacity slots of the dispatch.
//
// Design.
//  * One block of 256 threads per (expert, 64-row tile, 64-column tile):
//    blockIdx.z is the expert, as the expert dimension rides the Pallas
//    grid.  Each thread owns a 4 x 4 micro-tile of float32 accumulators.
//  * The Dm loop (the Pallas kernel's sequential K grid axis with its VMEM
//    accumulator) runs inside the block in steps of 32: tiles of x
//    (transposed) and w are staged in shared memory as float32, then each
//    thread issues 4 x 4 fmaf per step from two 16-byte shared loads.
//    Device memory is read in 16-byte vectors, and the next step's tiles
//    are fetched into registers while this step's are multiplied.
//  * Any C, Dm and F: chunks at the ragged edges (or rows not 16-byte
//    aligned) load element by element, zero-filled, and stores are masked
//    (the Pallas kernel asserts divisibility), so the decode shape
//    (C = 32) and the prefill shape run without padding.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry point returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;              // rows of x per block
constexpr int kBN = 64;              // columns of w per block
constexpr int kBK = 32;              // depth per step
constexpr int kPad = 4;              // floats of padding per shared row
constexpr int kThreads = 256;
static_assert(kBM * kBN == kThreads * 16, "4 x 4 outputs per thread");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);          // round to nearest even
}

// One 16-byte load of consecutive elements, widened to float32.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// VN consecutive elements of row `row` from column `col` of a (rows, cols)
// matrix into out, zero outside it: one 16-byte load when the chunk lies
// inside and rows are 16-byte aligned (`vec`), else element by element.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ a, int row,
                                           int rows, int col, int cols,
                                           bool vec, float* out) {
  constexpr int VN = Vec<T>::kN;
  const T* p = a + static_cast<long long>(row) * cols + col;
  if (vec && row < rows && col + VN <= cols) {
    Vec<T>::load(p, out);
    return;
  }
#pragma unroll
  for (int i = 0; i < VN; ++i) {
    out[i] = (row < rows && col + i < cols) ? to_f32(p[i]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) moe_gmm_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
    int rows, int depth, int cols, int x_vec, int w_vec) {
  constexpr int VN = Vec<T>::kN;
  constexpr int XC = kBK / VN;                     // chunks per x tile row
  constexpr int WC = kBN / VN;                     // chunks per w tile row
  constexpr int XIT = kBM * XC / kThreads;         // x chunks per thread
  constexpr int WIT = kBK * WC / kThreads;         // w chunks per thread
  static_assert(XIT * kThreads == kBM * XC && WIT * kThreads == kBK * WC,
                "whole chunks per thread");
  __shared__ __align__(16) float xs[kBK][kBM + kPad];   // [k][row]
  __shared__ __align__(16) float ws[kBK][kBN + kPad];   // [k][col]
  const int tid = threadIdx.x;
  const int tx = tid % 16;           // output columns n0 + 4*tx .. +3
  const int ty = tid / 16;           // output rows    m0 + 4*ty .. +3
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const long long ei = blockIdx.z;
  const T* xe = x + ei * rows * depth;
  const T* we = w + ei * depth * cols;
  T* oe = out + ei * rows * cols;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // The next step's tiles are loaded into registers while this step's
  // are multiplied, so a global load's latency is paid once, not per step.
  float xr[XIT][VN], wr[WIT][VN];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int it = 0; it < XIT; ++it) {
      const int c = it * kThreads + tid;
      load_chunk(xe, m0 + c / XC, rows, k0 + (c % XC) * VN, depth, x_vec, xr[it]);
    }
#pragma unroll
    for (int it = 0; it < WIT; ++it) {
      const int c = it * kThreads + tid;
      load_chunk(we, k0 + c / WC, depth, n0 + (c % WC) * VN, cols, w_vec, wr[it]);
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < depth; k0 += kBK) {
#pragma unroll
    for (int it = 0; it < XIT; ++it) {
      const int c = it * kThreads + tid;
#pragma unroll
      for (int i = 0; i < VN; ++i) xs[(c % XC) * VN + i][c / XC] = xr[it][i];
    }
#pragma unroll
    for (int it = 0; it < WIT; ++it) {
      const int c = it * kThreads + tid;
#pragma unroll
      for (int i = 0; i < VN; ++i) ws[c / WC][(c % WC) * VN + i] = wr[it][i];
    }
    __syncthreads();
    if (k0 + kBK < depth) fetch(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&xs[kk][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&ws[kk][4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * ty + i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 4 * tx + j;
      if (col < cols) store(oe + static_cast<long long>(row) * cols + col, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int experts, int rows,
           int depth, int cols, cudaStream_t stream) {
  constexpr int VN = Vec<T>::kN;
  const dim3 grid((cols + kBN - 1) / kBN, (rows + kBM - 1) / kBM, experts);
  const int x_vec = depth % VN == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int w_vec = cols % VN == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  moe_gmm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      rows, depth, cols, x_vec, w_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int moe_gmm_launch(const void* x, const void* w, void* out,
                              int experts, int rows, int depth, int cols,
                              int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, out, experts, rows, depth, cols, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, w, out, experts, rows, depth, cols, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* moe_gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
