// Flash attention backward (grouped K/V heads) on Hopper (sm_90a).
//
// Replaces the gradient that XLA derives for the reference's model
// attention (src/repro/models/attention.py, naive_attention and
// chunked_attention, differentiated by jax.value_and_grad in
// src/repro/distributed/trainstep.py); the JAX package has no backward
// Pallas kernel.  The forward is flash_attention.cu, which writes each
// row's log-sum-exp (LSE) when asked.
//
// With s_ij = (q_i . k_j) * scale, P_ij = exp(s_ij - LSE_i) (0 where the
// causal mask, j > i + q_offset, or the end of the keys hides key j):
//
//   D_i  = sum_d dO_id * O_id
//   dP_ij = dO_i . v_j,   dS_ij = P_ij * (dP_ij - D_i)
//   dV_j = sum_i P_ij dO_i,   dK_j = scale * sum_i dS_ij q_i,
//   dQ_i = scale * sum_j dS_ij k_j,
//
// summed over the query heads h of a kv head's group (h / rep = kv head)
// for dK and dV.  q, o, dO and dQ are (b, sq, H, D), k, v, dK and dV
// (b, skv, KVH, D), all contiguous, 16-byte aligned and all float32 or all
// bfloat16; LSE and D are float32 (b, H, sq).  Window and softcap are not
// differentiated here (the wrapper refuses them).  Every product is a
// float32 FMA on the CUDA cores from operands widened to float32 in shared
// memory; each output is rounded once to the input type.
//
// What bounds it on this card.  Five products of 2*D operations for each
// (query, key) pair the mask keeps (S, dP, dV, dK, dQ): 21.5 GFLOP at
// Granite's training call (b 4, sq = skv = 1,024, H 16, KVH 8, D 64,
// causal), 0.022 ms at the tensor cores' 989 TFLOP/s bf16 and 0.32 ms at
// the CUDA cores' 67 TFLOP/s float32, against 2.6 MB of bf16 operands
// (0.8 us at 3.35 TB/s): bound by operations.  This kernel recomputes S and
// dP in both passes (14*D operations a pair, not 10*D) and stays on the
// CUDA cores, so its floor is some 0.45 ms; tensor cores (mma_bf16.cuh),
// TMA and wgmma are later work.
//
// Design: two passes, deterministic, no atomics.
//  * dq pass (`flash_bwd_dq`): one block of 256 threads per (b*H, tile of
//    64 query rows), heaviest tiles first.  It stages its Q and dO tiles in
//    shared memory, computes the tile's D_i from dO and O (four lanes a row,
//    two xor shuffles) and writes D to a (b, H, sq) scratch, then walks the
//    key tiles up to the diagonal: S and dP by 4x4 register tiles a
//    thread, dS into shared memory transposed, dQ += dS.K by 4x4 register
//    tiles of (row, head dim).
//  * dk/dv pass (`flash_bwd_dkdv`), launched after it on the same stream:
//    one block per (b*KVH, tile of 64 keys), K and V staged once.  It walks
//    the query tiles at or below the diagonal of EVERY query head of the
//    kv head's group, recomputes S and dP, and sums dV += P^T.dO and
//    dK += dS^T.Q in registers: grouped-query attention needs no atomics
//    and no second reduction.
//  * Shared memory rows are float32 with 16 bytes of padding, so a warp's
//    16-byte reads of 16 rows at one column fall in distinct bank groups.
//    64 x 64 tiles: (4 * 64 rows of D + 4) + 64 x 68 floats, 87.5 KB at
//    D = 64 and 153 KB at D = 128 (dynamic shared memory, host_launch.cuh).
//  * Any sq and skv: rows past sq and keys past skv are zero-filled and
//    masked.  expf, fmaf and no fast-math intrinsics.
//
// The kernels allocate nothing (the wrapper hands in D's scratch) and
// launch on the caller's stream and card (host_launch.cuh's DeviceGuard);
// the C entry point returns cudaGetLastError() of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "host_launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;             // query rows a tile
constexpr int kKeys = 64;             // keys a tile
constexpr int kLdp = 64 + 4;          // floats a row of a P / dS tile

template <int D>
struct BwdTile {
  static constexpr int kLd = D + 4;   // floats a staged row of q, k, v or dO
  // 4x4 (row, head dim) accumulator blocks a thread holds: 16 x D/4 blocks.
  static constexpr int kPer = D >= 64 ? D / 64 : 1;
  static constexpr int kSmemBytes =
      (4 * 64 * kLd + 64 * kLdp + 2 * 64) * static_cast<int>(sizeof(float));
  static_assert(D % 16 == 0 && D <= 128, "D in {16, 32, 64, 128}");
};

// Four consecutive elements widened to float32, and back.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  __device__ __forceinline__ static float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ static void store(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  __device__ __forceinline__ static float4 load(const __nv_bfloat16* p) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, float4 x) {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(p);
    h[0] = __floats2bfloat162_rn(x.x, x.y);
    h[1] = __floats2bfloat162_rn(x.z, x.w);
  }
};

// Rows r0 .. r0 + 63 of a (rows, stride) operand into a [64][kLd] float
// tile; rows at or past n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int r0, int n) {
  constexpr int LD = BwdTile<D>::kLd;
  constexpr int C = D / 4;
  for (int c = threadIdx.x; c < 64 * C; c += kThreads) {
    const int r = c / C, col = (c % C) * 4;
    const int row = r0 + r;
    const float4 x = row < n ? Chunk<T>::load(src + row * stride + col)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * LD + col) = x;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// out[i][j] = a[tr + 16 i] . b[tc + 16 j] over D: a thread's 4x4 block of
// a 64 x 64 product of two staged tiles.
template <int D>
__device__ __forceinline__ void tile_dots(const float* a, const float* b,
                                          int tr, int tc, float out[4][4]) {
  constexpr int LD = BwdTile<D>::kLd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = *reinterpret_cast<const float4*>(a + (tr + 16 * i) * LD + d);
      bv[i] = *reinterpret_cast<const float4*>(b + (tc + 16 * i) * LD + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = dot4(av[i], bv[j], out[i][j]);
    }
  }
}

// acc[n][x][y] += sum_r w[r][4 rg + x] * t[r][4 dg + y] over the 64 rows r,
// for the thread's blocks (rg, dg) = divmod(threadIdx.x + n * kThreads, D / 4);
// w is a [64][kLdp] P or dS tile, t a staged [64][kLd] tile.
template <int D>
__device__ __forceinline__ void accumulate(const float* w, const float* t,
                                           float acc[][4][4]) {
  constexpr int LD = BwdTile<D>::kLd;
  constexpr int C = D / 4;
#pragma unroll
  for (int n = 0; n < BwdTile<D>::kPer; ++n) {
    const int blk = threadIdx.x + n * kThreads;
    if (blk >= 16 * C) break;
    const int rg = blk / C, dg = blk % C;
#pragma unroll 4
    for (int r = 0; r < 64; ++r) {
      const float4 wv = *reinterpret_cast<const float4*>(w + r * kLdp + 4 * rg);
      const float4 tv = *reinterpret_cast<const float4*>(t + r * LD + 4 * dg);
      const float wx[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        acc[n][x][0] = fmaf(wx[x], tv.x, acc[n][x][0]);
        acc[n][x][1] = fmaf(wx[x], tv.y, acc[n][x][1]);
        acc[n][x][2] = fmaf(wx[x], tv.z, acc[n][x][2]);
        acc[n][x][3] = fmaf(wx[x], tv.w, acc[n][x][3]);
      }
    }
  }
}

// Rows r0 + 4 rg + x (below n) of the thread's blocks, times `mul`, into a
// (rows, stride) output in its type.
template <typename T, int D>
__device__ __forceinline__ void store_blocks(T* out, long long stride, int r0,
                                             int n, float acc[][4][4],
                                             float mul) {
  constexpr int C = D / 4;
#pragma unroll
  for (int k = 0; k < BwdTile<D>::kPer; ++k) {
    const int blk = threadIdx.x + k * kThreads;
    if (blk >= 16 * C) break;
    const int rg = blk / C, dg = blk % C;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int row = r0 + 4 * rg + x;
      if (row < n) {
        Chunk<T>::store(out + row * stride + 4 * dg,
                        make_float4(acc[k][x][0] * mul, acc[k][x][1] * mul,
                                    acc[k][x][2] * mul, acc[k][x][3] * mul));
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta,
    T* __restrict__ dq, int sq, int skv, int heads, int kv_heads, int causal,
    int q_offset, float scale) {
  constexpr int LD = BwdTile<D>::kLd;
  constexpr int PER = BwdTile<D>::kPer;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [64][LD]
  float* dos = qs + kRows * LD;           // [64][LD]
  float* ks = dos + kRows * LD;           // [64][LD]
  float* vs = ks + kKeys * LD;            // [64][LD]
  float* dst = vs + kKeys * LD;           // [64 keys][kLdp]: dS transposed
  float* ls = dst + kKeys * kLdp;         // [64] LSE of the tile's rows
  float* ds = ls + kRows;                 // [64] D of the tile's rows

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int bi = blockIdx.x / heads;
  const int hi = blockIdx.x % heads;
  const int kvi = hi / (heads / kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const long long q_row = static_cast<long long>(heads) * D;
  const long long kv_row = static_cast<long long>(kv_heads) * D;
  const long long q_base = static_cast<long long>(bi) * sq * q_row +
                           static_cast<long long>(hi) * D;
  const long long kv_base = static_cast<long long>(bi) * skv * kv_row +
                            static_cast<long long>(kvi) * D;
  const long long row_base = (static_cast<long long>(bi) * heads + hi) * sq;

  load_tile<T, D>(qs, q + q_base, q_row, q0, sq);
  load_tile<T, D>(dos, dout + q_base, q_row, q0, sq);
  if (tid < kRows) ls[tid] = q0 + tid < sq ? lse[row_base + q0 + tid] : 0.f;
  __syncthreads();

  // D_i = dO_i . O_i: four lanes a row, D/4 head dims each.
  {
    const int r = tid / 4, part = tid % 4;
    const int row = q0 + r;
    float sum = 0.f;
    if (row < sq) {
      const T* op = o + q_base + row * q_row + part * (D / 4);
      const float* dp = dos + r * LD + part * (D / 4);
#pragma unroll
      for (int c = 0; c < D / 4; c += 4) {
        sum = dot4(*reinterpret_cast<const float4*>(dp + c), Chunk<T>::load(op + c), sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      ds[r] = sum;
      if (row < sq) delta[row_base + row] = sum;
    }
  }

  float acc[PER][4][4];
#pragma unroll
  for (int n = 0; n < PER; ++n) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[n][x][y] = 0.f;
    }
  }
  int kv_end = skv;
  if (causal) kv_end = min(skv, max(0, q0 + kRows + q_offset));
  for (int k0 = 0; k0 < kv_end; k0 += kKeys) {
    __syncthreads();                      // the previous tiles have been read
    load_tile<T, D>(ks, k + kv_base, kv_row, k0, skv);
    load_tile<T, D>(vs, v + kv_base, kv_row, k0, skv);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dots<D>(qs, ks, tr, tc, s);
    tile_dots<D>(dos, vs, tr, tc, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        const int key = k0 + c;
        const bool seen = row < sq && key < skv && (!causal || key <= row + q_offset);
        const float p = seen ? expf(s[i][j] * scale - ls[r]) : 0.f;
        dst[c * kLdp + r] = p * (dp[i][j] - ds[r]);
      }
    }
    __syncthreads();
    accumulate<D>(dst, ks, acc);
  }
  store_blocks<T, D>(dq + q_base, q_row, q0, sq, acc, scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int sq, int skv, int heads, int kv_heads, int causal, int q_offset,
    float scale) {
  constexpr int LD = BwdTile<D>::kLd;
  constexpr int PER = BwdTile<D>::kPer;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                       // [64][LD]
  float* vs = ks + kKeys * LD;            // [64][LD]
  float* qs = vs + kKeys * LD;            // [64][LD]
  float* dos = qs + kRows * LD;           // [64][LD]
  float* ps = dos + kRows * LD;           // [64 rows][kLdp]: P, then dS
  float* ls = ps + kRows * kLdp;          // [64] LSE of the tile's rows
  float* ds = ls + kRows;                 // [64] D of the tile's rows

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int bi = blockIdx.x / kv_heads;
  const int kvi = blockIdx.x % kv_heads;
  const int k0 = blockIdx.y * kKeys;
  const int rep = heads / kv_heads;
  const long long q_row = static_cast<long long>(heads) * D;
  const long long kv_row = static_cast<long long>(kv_heads) * D;
  const long long kv_base = static_cast<long long>(bi) * skv * kv_row +
                            static_cast<long long>(kvi) * D;

  load_tile<T, D>(ks, k + kv_base, kv_row, k0, skv);
  load_tile<T, D>(vs, v + kv_base, kv_row, k0, skv);

  float adk[PER][4][4], adv[PER][4][4];
#pragma unroll
  for (int n = 0; n < PER; ++n) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
#pragma unroll
      for (int y = 0; y < 4; ++y) adk[n][x][y] = adv[n][x][y] = 0.f;
    }
  }
  // Query tiles wholly below the mask (every row's last key before k0)
  // are skipped.
  int q_begin = 0;
  if (causal) q_begin = max(0, k0 - q_offset) / kRows * kRows;
  for (int g = 0; g < rep; ++g) {
    const int hi = kvi * rep + g;
    const long long q_base = static_cast<long long>(bi) * sq * q_row +
                             static_cast<long long>(hi) * D;
    const long long row_base = (static_cast<long long>(bi) * heads + hi) * sq;
    for (int q0 = q_begin; q0 < sq; q0 += kRows) {
      __syncthreads();                    // the previous tiles have been read
      load_tile<T, D>(qs, q + q_base, q_row, q0, sq);
      load_tile<T, D>(dos, dout + q_base, q_row, q0, sq);
      if (tid < kRows) {
        const bool in = q0 + tid < sq;
        ls[tid] = in ? lse[row_base + q0 + tid] : 0.f;
        ds[tid] = in ? delta[row_base + q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_dots<D>(qs, ks, tr, tc, s);
      tile_dots<D>(dos, vs, tr, tc, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tr + 16 * i;
        const int row = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tc + 16 * j;
          const int key = k0 + c;
          const bool seen = row < sq && key < skv && (!causal || key <= row + q_offset);
          const float p = seen ? expf(s[i][j] * scale - ls[r]) : 0.f;
          ps[r * kLdp + c] = p;
          dp[i][j] = p * (dp[i][j] - ds[r]);
        }
      }
      __syncthreads();
      accumulate<D>(ps, dos, adv);        // dV += P^T . dO
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) ps[(tr + 16 * i) * kLdp + tc + 16 * j] = dp[i][j];
      }
      __syncthreads();
      accumulate<D>(ps, qs, adk);         // dK += dS^T . Q
    }
  }
  store_blocks<T, D>(dk + kv_base, kv_row, k0, skv, adk, scale);
  store_blocks<T, D>(dv + kv_base, kv_row, k0, skv, adv, 1.f);
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* delta, void* dq,
               void* dk, void* dv, int b, int sq, int skv, int heads,
               int kv_heads, int causal, int q_offset, float scale,
               cudaStream_t stream) {
  constexpr int kSmem = BwdTile<D>::kSmemBytes;
  // More than the default 48 KB of dynamic shared memory: granted once per
  // instance and card (host_launch.cuh).
  static int granted_dq[host_launch::kMaxDevices] = {};
  static int granted_kv[host_launch::kMaxDevices] = {};
  cudaError_t err = host_launch::opt_in(flash_bwd_dq<T, D>, granted_dq, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = host_launch::opt_in(flash_bwd_dkdv<T, D>, granted_kv, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  float* dt = static_cast<float*>(delta);
  flash_bwd_dq<T, D><<<dim3(b * heads, (sq + kRows - 1) / kRows), kThreads,
                       kSmem, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, lt, dt, static_cast<T*>(dq),
      sq, skv, heads, kv_heads, causal, q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv<T, D><<<dim3(b * kv_heads, (skv + kKeys - 1) / kKeys),
                         kThreads, kSmem, stream>>>(
      qt, kt, vt, dot, lt, dt, static_cast<T*>(dk), static_cast<T*>(dv), sq,
      skv, heads, kv_heads, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_d(int d, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, const void* lse, void* delta,
                 void* dq, void* dk, void* dv, int b, int sq, int skv,
                 int heads, int kv_heads, int causal, int q_offset, float scale,
                 cudaStream_t s) {
  switch (d) {
    case 16: return launch_bwd<T, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, heads, kv_heads, causal, q_offset, scale, s);
    case 32: return launch_bwd<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, heads, kv_heads, causal, q_offset, scale, s);
    case 64: return launch_bwd<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, heads, kv_heads, causal, q_offset, scale, s);
    case 128: return launch_bwd<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, heads, kv_heads, causal, q_offset, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int bwd_smem_bytes(int d) {
  switch (d) {
    case 16: return BwdTile<16>::kSmemBytes;
    case 32: return BwdTile<32>::kSmemBytes;
    case 64: return BwdTile<64>::kSmemBytes;
    case 128: return BwdTile<128>::kSmemBytes;
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  delta is a float32 (b, heads, sq)
// scratch that the dq pass writes and the dk/dv pass reads.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int b, int sq, int skv, int heads, int kv_heads, int d,
    int dtype, int causal, int q_offset, float scale, int device,
    void* stream) {
  const host_launch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_bwd_d<float>(d, q, k, v, o, dout, lse, delta, dq, dk, dv, b,
                               sq, skv, heads, kv_heads, causal, q_offset,
                               scale, s);
  }
  if (dtype == 1) {
    return launch_bwd_d<__nv_bfloat16>(d, q, k, v, o, dout, lse, delta, dq, dk,
                                       dv, b, sq, skv, heads, kv_heads, causal,
                                       q_offset, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of both backward kernels for head dim d (-1: none).
extern "C" int flash_attention_bwd_smem_bytes(int d) { return bwd_smem_bytes(d); }

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
