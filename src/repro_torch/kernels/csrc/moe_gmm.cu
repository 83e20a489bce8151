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
// The type picks one of two kernels:
//  * bfloat16: `moe_gmm_mma_kernel`, on the tensor cores;
//  * float32: `moe_gmm_kernel`, on the CUDA cores in full float32 (no
//    reduced-precision tensor-core shortcut: the port holds this route to
//    1e-5 of its plain version).
//
// What bounds it on this card.  The bytes are the weights, E*Dm*F
// elements, plus x and out; the operations are 2*E*C*Dm*F.  At decode
// (E = 32, C = 4 * 8, Dm = 1024, F = 512, bfloat16) the weights are 33.6 MB
// a launch and each 2-byte weight takes part in 2*C = 64 operations, 32 a
// byte, far below the ~295 a byte the tensor cores need: bound by bytes,
// 11 us at 3.35 TB/s.  At prefill (C = 4 * 320) the two are close: 48 us
// for the bytes of x, w and the output, 43 us for the operations at
// 989 TFLOP/s bf16.  Float32 has only the CUDA cores (67 TFLOP/s).
//
// Design of the bfloat16 kernel (PTX wrappers in mma_bf16.cuh).
//  * blockIdx.z is the expert, as the expert dimension rides the Pallas
//    grid; the Dm loop (the Pallas kernel's sequential K grid axis with its
//    VMEM accumulator) runs inside the block over a ring of shared-memory
//    stages filled by cp.async, STAGES - 1 tiles ahead of the one being
//    multiplied, with one barrier a step.
//  * The launcher picks the block tile from C, a fixed choice and not a
//    knob: more than 64 rows (prefill), 128 x 128 x 32 over 8 warps of
//    64 x 32 each, 4 stages; at most 64 rows (decode), 32 rows x 64
//    columns x 64 deep over 4 warps, 4 stages, so that E*F/64 = 256-512
//    blocks stream the weights at the memory's rate (33-64 rows take two
//    row tiles, the second reading the weights from L2).
//  * Products by mma.sync m16n8k16 with float32 accumulators: x's tile
//    (row-major, Dm contiguous) through ldmatrix, w's (F contiguous)
//    through ldmatrix.trans.  Shared rows are padded by 16 bytes, so
//    ldmatrix's eight row addresses fall in distinct banks.
//  * Any C, Dm and F: rows and columns past the edges are zero-filled
//    (cp.async's src-size 0) and the stores are masked.  When Dm (or F) is
//    not a multiple of 8, or x (or w) is not 16-byte aligned, that operand
//    fills shared memory by element loads instead of cp.async (`x_vec`,
//    `w_vec`); the products stay on the tensor cores.
//
// Design of the float32 kernel.
//  * One block of 256 threads per (expert, 64-row tile, 64-column tile):
//    blockIdx.z is the expert.  Each thread owns a 4 x 4 micro-tile of
//    float32 accumulators.
//  * The Dm loop runs inside the block in steps of 32: tiles of x
//    (transposed) and w are staged in shared memory, then each thread
//    issues 4 x 4 fmaf per step from two 16-byte shared loads.  Device
//    memory is read in 16-byte vectors, and the next step's tiles are
//    fetched into registers while this step's are multiplied.
//  * Any C, Dm and F: chunks at the ragged edges (or rows not 16-byte
//    aligned) load element by element, zero-filled, and stores are masked
//    (the Pallas kernel asserts divisibility).
//
// The kernels allocate nothing and launch on the caller's stream and
// card (host_launch.cuh's DeviceGuard); the C
// entry point returns cudaGetLastError() of its launch (or the error of
// raising the bfloat16 kernel's dynamic shared-memory limit).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "host_launch.cuh"

namespace {

// -- float32: CUDA cores -------------------------------------------------------

constexpr int kBM = 64;              // rows of x per block
constexpr int kBN = 64;              // columns of w per block
constexpr int kBK = 32;              // depth per step
constexpr int kPad = 4;              // floats of padding per shared row
constexpr int kThreads = 256;
static_assert(kBM * kBN == kThreads * 16, "4 x 4 outputs per thread");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// -- bfloat16: tensor cores ----------------------------------------------------

// Block tile BM x BN, BK deep, over WM x WN warps; STAGES shared buffers.
template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct GmmTile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int kWarpRows = BM / WM, kWarpCols = BN / WN;
  static constexpr int MT = kWarpRows / 16;   // m16 tiles a warp
  static constexpr int NT = kWarpCols / 8;    // n8 tiles a warp
  static constexpr int kLdA = BK + 8;         // bf16 a shared row of x's tile
  static constexpr int kLdB = BN + 8;         // bf16 a shared row of w's tile
  static constexpr int kStageA = BM * kLdA;
  static constexpr int kStageB = BK * kLdB;
  static constexpr int kSmemBytes = STAGES * (kStageA + kStageB) *
                                    static_cast<int>(sizeof(__nv_bfloat16));
  static_assert(kWarpRows % 16 == 0 && kWarpCols % 16 == 0 && BK % 16 == 0,
                "whole mma tiles a warp, ldmatrix.x4 pairs of n-blocks");
  static_assert(BM * BK / 8 % kThreads == 0 && BK * BN / 8 % kThreads == 0,
                "whole 16-byte chunks a thread");
};
using GmmPrefill = GmmTile<128, 128, 32, 2, 4, 4>;
using GmmDecode = GmmTile<32, 64, 64, 2, 2, 4>;

// 8 consecutive elements of row `row` from column `col` of a (rows, cols)
// bf16 matrix into 16 bytes of shared memory, zero outside the matrix.
__device__ __forceinline__ void fill8(__nv_bfloat16* dst,
                                      const __nv_bfloat16* __restrict__ a,
                                      int row, int rows, int col, int cols) {
  uint32_t packed[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t lo = 0, hi = 0;
    if (row < rows) {
      const __nv_bfloat16* p = a + static_cast<long long>(row) * cols + col;
      if (col + 2 * i < cols) lo = __bfloat16_as_ushort(p[2 * i]);
      if (col + 2 * i + 1 < cols) hi = __bfloat16_as_ushort(p[2 * i + 1]);
    }
    packed[i] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

// out[row, col .. col + 1] = (v0, v1) rounded to bf16, inside the matrix.
__device__ __forceinline__ void store2(__nv_bfloat16* __restrict__ out,
                                       int row, int rows, int col, int cols,
                                       float v0, float v1) {
  if (row >= rows) return;
  __nv_bfloat16* p = out + static_cast<long long>(row) * cols + col;
  if (col + 1 < cols && cols % 2 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < cols) p[0] = __float2bfloat16_rn(v0);
    if (col + 1 < cols) p[1] = __float2bfloat16_rn(v1);
  }
}

template <class Tile>
__global__ void __launch_bounds__(Tile::kThreads) moe_gmm_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    __nv_bfloat16* __restrict__ out, int rows, int depth, int cols, int x_vec,
    int w_vec) {
  using namespace mma_bf16;
  using namespace ptx;
  constexpr int BM = Tile::BM, BN = Tile::BN, BK = Tile::BK;
  constexpr int STAGES = Tile::STAGES, THREADS = Tile::kThreads;
  constexpr int MT = Tile::MT, NT = Tile::NT;
  constexpr int LDA = Tile::kLdA, LDB = Tile::kLdB;
  constexpr int AC = BK / 8, BC = BN / 8;     // 16-byte chunks a tile row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [STAGES][BM][LDA]
  __nv_bfloat16* bs = as + STAGES * Tile::kStageA;                  // [STAGES][BK][LDB]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wr = (warp / Tile::WN) * Tile::kWarpRows;   // the warp's rows
  const int wc = (warp % Tile::WN) * Tile::kWarpCols;   // and columns
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const long long ei = blockIdx.z;
  const __nv_bfloat16* xe = x + ei * rows * depth;
  const __nv_bfloat16* we = w + ei * depth * cols;
  __nv_bfloat16* oe = out + ei * rows * cols;
  const int k_tiles = (depth + BK - 1) / BK;

  auto load_tile = [&](int kt, int stage) {
    const int k0 = kt * BK;
    __nv_bfloat16* ad = as + stage * Tile::kStageA;
    __nv_bfloat16* bd = bs + stage * Tile::kStageB;
#pragma unroll
    for (int i = 0; i < BM * AC / THREADS; ++i) {
      const int c = i * THREADS + tid;
      const int r = c / AC, col = (c % AC) * 8;
      const int row = m0 + r, kk = k0 + col;
      if (x_vec) {
        const bool in = row < rows && kk < depth;
        cp_async_16(ad + r * LDA + col,
                    xe + (in ? static_cast<long long>(row) * depth + kk : 0), in ? 16 : 0);
      } else {
        fill8(ad + r * LDA + col, xe, row, rows, kk, depth);
      }
    }
#pragma unroll
    for (int i = 0; i < BK * BC / THREADS; ++i) {
      const int c = i * THREADS + tid;
      const int r = c / BC, col = (c % BC) * 8;
      const int kk = k0 + r, n = n0 + col;
      if (w_vec) {
        const bool in = kk < depth && n < cols;
        cp_async_16(bd + r * LDB + col,
                    we + (in ? static_cast<long long>(kk) * cols + n : 0), in ? 16 : 0);
      } else {
        fill8(bd + r * LDB + col, we, kk, depth, n, cols);
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();          // tile kt has landed (this thread's part)
    __syncthreads();                      // ... everyone's; stage kt - 1 is free
    const int next = kt + STAGES - 1;
    if (next < k_tiles) load_tile(next, next % STAGES);
    cp_async_commit();
    const __nv_bfloat16* a_s = as + (kt % STAGES) * Tile::kStageA;
    const __nv_bfloat16* b_s = bs + (kt % STAGES) * Tile::kStageB;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[MT][4];
      uint32_t bf[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        ldmatrix_x4(af[mt], a_s + (wr + mt * 16 + (lane & 15)) * LDA + ks * 16 +
                                (lane >> 4) * 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, b_s + (ks * 16 + (lane & 15)) * LDB + wc + nt * 8 +
                                 (lane >> 4) * 8);
        bf[nt][0] = b[0];
        bf[nt][1] = b[1];
        bf[nt + 1][0] = b[2];
        bf[nt + 1][1] = b[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16_16816(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  }
  cp_async_wait<0>();                     // no copy outlives the block

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row = m0 + wr + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + wc + nt * 8 + 2 * t;
      store2(oe, row, rows, col, cols, acc[mt][nt][0], acc[mt][nt][1]);
      store2(oe, row + 8, rows, col, cols, acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

template <class Tile>
int launch_mma_tile(const void* x, const void* w, void* out, int experts,
                    int rows, int depth, int cols, cudaStream_t stream) {
  // More than the default 48 KB of dynamic shared memory: granted once per
  // instance and card (host_launch.cuh).
  static int granted[host_launch::kMaxDevices] = {};
  const cudaError_t attr =
      host_launch::opt_in(moe_gmm_mma_kernel<Tile>, granted, Tile::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((cols + Tile::BN - 1) / Tile::BN,
                  (rows + Tile::BM - 1) / Tile::BM, experts);
  const int x_vec = depth % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int w_vec = cols % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  moe_gmm_mma_kernel<Tile><<<grid, Tile::kThreads, Tile::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), rows, depth, cols, x_vec, w_vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const void* x, const void* w, void* out, int experts, int rows,
               int depth, int cols, cudaStream_t stream) {
  if (rows <= 64) {
    return launch_mma_tile<GmmDecode>(x, w, out, experts, rows, depth, cols, stream);
  }
  return launch_mma_tile<GmmPrefill>(x, w, out, experts, rows, depth, cols, stream);
}

int mma_smem_bytes(int rows) {
  if (rows <= 64) return GmmDecode::kSmemBytes;
  return GmmPrefill::kSmemBytes;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).
extern "C" int moe_gmm_launch(const void* x, const void* w, void* out,
                              int experts, int rows, int depth, int cols,
                              int dtype, int device, void* stream) {
  const host_launch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, out, experts, rows, depth, cols, s);
  if (dtype == 1) return launch_mma(x, w, out, experts, rows, depth, cols, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of the bfloat16 kernel for `rows` rows an expert.
extern "C" int moe_gmm_bf16_smem_bytes(int rows) { return mma_smem_bytes(rows); }

extern "C" const char* moe_gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
