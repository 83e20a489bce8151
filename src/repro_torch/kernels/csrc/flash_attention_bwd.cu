// Flash attention backward (grouped K/V heads) on Hopper (sm_90a).
//
// Replaces the gradient that XLA derives for the reference's model
// attention (src/repro/models/attention.py, naive_attention and
// chunked_attention, differentiated by jax.value_and_grad in
// src/repro/distributed/trainstep.py); the JAX package has no backward
// Pallas kernel.  The forward is flash_attention.cu, which writes each
// row's log-sum-exp (LSE) when asked.
//
// With s_ij = cap((q_i . k_j) * scale), cap(x) = softcap * tanh(x / softcap)
// (x itself when softcap = 0), and P_ij = exp(s_ij - LSE_i) (0 where a mask
// hides key j: the causal mask, j > i + q_offset; the window, when
// window > 0, j <= i + q_offset - window; the end of the keys):
//
//   D_i  = sum_d dO_id * O_id
//   dP_ij = dO_i . v_j,   dS_ij = P_ij * (dP_ij - D_i) * (1 - t_ij^2),
//   t_ij = s_ij / softcap (the chain rule through the cap; 1 without one),
//   dV_j = sum_i P_ij dO_i,   dK_j = scale * sum_i dS_ij q_i,
//   dQ_i = scale * sum_j dS_ij k_j,
//
// summed over the query heads h of a kv head's group (h / rep = kv head)
// for dK and dV.  q, o, dO and dQ are (b, sq, H, D), k, v, dK and dV
// (b, skv, KVH, D), all contiguous, 16-byte aligned and all float32 or all
// bfloat16; LSE and D are float32 (b, H, sq), LSE from the forward with the
// same masks and cap.  A query row that sees no key is refused by the
// wrapper, as in the forward.  The type picks the kernels:
//  * bfloat16: `flash_bwd_dq_bf16_mma` then `flash_bwd_dkdv_bf16_mma`, on
//    the tensor cores (PTX wrappers in mma_bf16.cuh and ptx_copy.cuh);
//  * float32: `flash_bwd_dq` then `flash_bwd_dkdv`, float32 FMA on the
//    CUDA cores from operands staged in shared memory (no TF32: the port
//    holds this route to 1e-5 of its plain version).
// Each output is rounded once to the input type.
//
// What bounds it on this card.  Five products of 2*D operations for each
// (query, key) pair the mask keeps (S, dP, dV, dK, dQ): 21.5 GFLOP at
// Granite's training call (b 4, sq = skv = 1,024, H 16, KVH 8, D 64,
// causal), 0.022 ms at the tensor cores' 989 TFLOP/s bf16 and 0.32 ms at
// the CUDA cores' 67 TFLOP/s float32, against 2.6 MB of bf16 operands
// (0.8 us at 3.35 TB/s): bound by operations.  Both routes recompute S and
// dP in each pass (14*D operations a pair, not 10*D, 0.030 ms at the bf16
// peak): the price of a deterministic result without atomics.  mma.sync
// reaches a part of that peak only (wgmma and TMA, which reach the rest,
// are later work), and the exponentials and the elementwise dS between
// the products run on the CUDA cores.
//
// Both routes: two passes, deterministic, no atomics.
//  * The dq pass, one block per (b*H, tile of 64 query rows), heaviest
//    tiles first, computes the tile's D_i from dO and O, writes D to a
//    (b, H, sq) scratch, and walks the key tiles up to the diagonal.
//  * The dk/dv pass, launched after it on the same stream, one block per
//    (b*KVH, tile of 64 keys), walks the query tiles at or below the
//    diagonal of EVERY query head of the kv head's group, recomputes S and
//    dP, and sums dV += P^T.dO and dK += dS^T.Q in registers:
//    grouped-query attention needs no atomics and no second reduction.
//  * Key (dq) and query (dk/dv) tiles that the causal mask or the window
//    hides wholly are never loaded; tiles they hide in part are masked
//    element by element.  Any sq and skv: rows past sq and keys past skv
//    are zero-filled and masked; q_offset shifts the causal diagonal.
//  * Softcap: the cap is recomputed from S with tanhf (no approximate
//    tanh), P from the capped score, and dS multiplied by 1 - t^2 before it
//    is rounded (bfloat16: into the A fragments), t held in a register
//    only for its element.  The bfloat16 kernels take the window and the
//    cap as template flags (four instances a pass and head dim), so the
//    instances without them keep the unmasked code as it was (the masked
//    dq pass at D = 128 reads dO's fragments from shared memory each tile
//    instead of holding them), and the window's lower edge relative to a
//    row (q_offset - window) and the cap's two constants (scale / softcap,
//    softcap log2(e)) arrive as kernel parameters, read from the constant
//    bank, not held in registers: at D = 128 the passes sit at 255
//    registers.
//
// Design of the bfloat16 kernels (4 warps a block, 16 rows or keys each).
//  * dq pass: the Q and dO tiles are copied to shared memory once and
//    held in registers as A fragments (ldmatrix).  K and V tiles of 64 keys
//    arrive by cp.async in a 2-stage ring, the next tile's copy in flight
//    while this one is used.  Per tile, S = Q.K^T and dP = dO.V^T by
//    mma.sync m16n8k16 (K, V as n-major B fragments); then, in the C
//    registers, P = exp2(S scale log2(e) - LSE log2(e)) (0 where masked,
//    only on tiles that cross the diagonal or the end of the keys) and
//    dS = P (dP - D); dS is rounded to bf16 and reused as the A fragment of
//    dQ += dS.K (K through ldmatrix.trans).  dS never goes through shared
//    memory.
//  * dk/dv pass, transposed: each warp holds its 16 keys' K and V as A
//    fragments; Q and dO tiles, with their rows' LSE and D, arrive by
//    cp.async in a 2-stage ring.  Per tile, S^T = K.Q^T and dP^T = V.dO^T
//    (Q, dO as n-major B fragments); each column's LSE and D come from the
//    ring's small arrays; P^T and dS^T are rounded to bf16 A fragments in
//    registers for dV += P^T.dO and dK += dS^T.Q (dO, Q through
//    ldmatrix.trans).  dK and dV (16 x D float32 a warp) stay in registers
//    across the whole group walk and are written once.
//  * Register budget: a warp works through each 64-wide tile in two halves
//    of 32 keys (dq) or query rows (dk/dv), so S and dP take 32 registers a
//    lane; at D = 128, where dK and dV take 128, the dk/dv pass reads its K
//    and V fragments again from shared memory each tile instead of holding
//    them.  No instance spills (ptxas -v).
//  * Numerics: P and dS are rounded to bf16 before the dV, dK and dQ
//    products (2^-9 relative each), as the forward rounds P before P.V and
//    SDPA's backward does; every sum is float32 and each output is
//    rounded once.
//  * Shared memory rows are bf16 padded by 16 bytes, so ldmatrix's eight
//    row addresses fall in distinct banks: six 64-row tiles, about 55 KB at
//    D = 64 and 103 KB at D = 128 (dynamic shared memory, host_launch.cuh).
//
// Design of the float32 kernels (256 threads a block): the tiles are
// staged in shared memory as float32 rows padded by 16 bytes; S and dP by
// 4x4 register tiles a thread; dS goes through shared memory (transposed
// in the dq pass; P and then dS in the dk/dv pass); 64 x 64 tiles take
// (4 * 64 rows of D + 4) + 64 x 68 floats, 87.5 KB at D = 64 and 153 KB at
// D = 128.  expf, fmaf and no fast-math intrinsics.
//
// The kernels allocate nothing (the wrapper hands in D's scratch) and
// launch on the caller's stream and card (host_launch.cuh's DeviceGuard);
// the C entry point returns cudaGetLastError() of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "host_launch.cuh"

namespace {

// -- float32: CUDA cores -------------------------------------------------------

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

// Four consecutive float32 elements.
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
    int q_offset, int window, float softcap, float scale) {
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
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 + q_offset - window + 1) / kKeys * kKeys;
  for (int k0 = kv_begin; k0 < kv_end; k0 += kKeys) {
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
        const bool seen = row < sq && key < skv && (!causal || key <= row + q_offset) &&
                          (window <= 0 || key > row + q_offset - window);
        float sc = s[i][j] * scale, dcap = 1.f;
        if (softcap > 0.f) {
          const float t = tanhf(sc / softcap);
          sc = t * softcap;
          dcap = 1.f - t * t;
        }
        const float p = seen ? expf(sc - ls[r]) : 0.f;
        dst[c * kLdp + r] = p * (dp[i][j] - ds[r]) * dcap;
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
    int window, float softcap, float scale) {
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
  // Query tiles wholly below the causal mask (every row's last key before
  // k0) or past the window (every row's first key after the tile's last)
  // are skipped.
  int q_begin = 0;
  if (causal) q_begin = max(0, k0 - q_offset) / kRows * kRows;
  int q_end = sq;
  if (window > 0) q_end = min(sq, max(0, k0 + kKeys - 1 - q_offset + window));
  for (int g = 0; g < rep; ++g) {
    const int hi = kvi * rep + g;
    const long long q_base = static_cast<long long>(bi) * sq * q_row +
                             static_cast<long long>(hi) * D;
    const long long row_base = (static_cast<long long>(bi) * heads + hi) * sq;
    for (int q0 = q_begin; q0 < q_end; q0 += kRows) {
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
          const bool seen = row < sq && key < skv &&
                            (!causal || key <= row + q_offset) &&
                            (window <= 0 || key > row + q_offset - window);
          float sc = s[i][j] * scale, dcap = 1.f;
          if (softcap > 0.f) {
            const float t = tanhf(sc / softcap);
            sc = t * softcap;
            dcap = 1.f - t * t;
          }
          const float p = seen ? expf(sc - ls[r]) : 0.f;
          ps[r * kLdp + c] = p;
          dp[i][j] = p * (dp[i][j] - ds[r]) * dcap;
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
               int kv_heads, int causal, int q_offset, int window, float softcap,
               float scale, cudaStream_t stream) {
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
      sq, skv, heads, kv_heads, causal, q_offset, window, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv<T, D><<<dim3(b * kv_heads, (skv + kKeys - 1) / kKeys),
                         kThreads, kSmem, stream>>>(
      qt, kt, vt, dot, lt, dt, static_cast<T*>(dk), static_cast<T*>(dv), sq,
      skv, heads, kv_heads, causal, q_offset, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_d(int d, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, const void* lse, void* delta,
                 void* dq, void* dk, void* dv, int b, int sq, int skv,
                 int heads, int kv_heads, int causal, int q_offset, int window,
                 float softcap, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch_bwd<T, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, heads, kv_heads, causal, q_offset, window, softcap, scale, s);
    case 32: return launch_bwd<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, heads, kv_heads, causal, q_offset, window, softcap, scale, s);
    case 64: return launch_bwd<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, heads, kv_heads, causal, q_offset, window, softcap, scale, s);
    case 128: return launch_bwd<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, heads, kv_heads, causal, q_offset, window, softcap, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// -- bfloat16: tensor cores ----------------------------------------------------

constexpr int kMmaThreads = 128;      // 4 warps: 16 query rows or keys each
constexpr int kMmaTile = 64;          // query rows or keys a tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct MmaBwd {
  static constexpr int kLd = D + 8;   // bf16 a staged row: 16 bytes of padding
  static constexpr int kChunks = D / 8;   // 16-byte chunks a row
  static constexpr int kKc = D / 16;      // k steps over the head dim
  static constexpr int kDb = D / 8;       // n-blocks of 8 head dims
  static constexpr int kTile = kMmaTile * kLd;  // bf16 a staged tile
  // Keys (dq pass) or query rows (dk/dv pass) whose S and dP a warp holds
  // in registers at once: half a tile, 32 registers a lane for both.  With
  // a whole tile ptxas spilled the dq pass at D = 64.
  static constexpr int kSub = kMmaTile / 2;
  // The dk/dv pass keeps K and V as A fragments in registers up to D = 64,
  // where reading them again each tile ran slower; at D = 128, where dK
  // and dV take 128 registers a lane, it reads them again from shared
  // memory each tile.
  static constexpr bool kHoldKv = D <= 64;
  // dq: Q, dO, a 2-stage ring of K and V tiles, the tile rows' D.
  static constexpr int kDqSmemBytes =
      6 * kTile * static_cast<int>(sizeof(__nv_bfloat16)) + kMmaTile * 4;
  // dk/dv: K, V, a 2-stage ring of Q and dO tiles with their rows' LSE and D.
  static constexpr int kDkdvSmemBytes =
      6 * kTile * static_cast<int>(sizeof(__nv_bfloat16)) + 2 * 2 * kMmaTile * 4;
  static_assert(D % 16 == 0 && D <= 128, "D in {16, 32, 64, 128}");
  static_assert(kMmaTile * kChunks % kMmaThreads == 0, "whole chunks a thread");
};

// Rows r0 .. r0 + 63 (below n) of a (rows, stride) bf16 operand into a
// [64][kLd] tile by cp.async, 16 bytes a copy; rows at or past n are
// zero-filled.
template <int D>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int r0, int n) {
  constexpr int LD = MmaBwd<D>::kLd;
  constexpr int CH = MmaBwd<D>::kChunks;
#pragma unroll
  for (int i = 0; i < kMmaTile * CH / kMmaThreads; ++i) {
    const int c = i * kMmaThreads + threadIdx.x;
    const int r = c / CH, col = (c % CH) * 8;
    const bool in = r0 + r < n;
    ptx::cp_async_16(dst + r * LD + col, src + (in ? (r0 + r) * stride : 0) + col,
                     in ? 16 : 0);
  }
}

// A warp's 16 rows of a C-fragment accumulator [kDb][4], times `mul`,
// rounded once to bf16 and staged through `stage` (the warp's own 16
// rows of a [.][kLd] tile), then stored in 16-byte chunks to rows
// r0 .. r0 + 15 (below n) of a (rows, stride) output.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long stride,
                                           int r0, int n, __nv_bfloat16* stage,
                                           const float (&acc)[MmaBwd<D>::kDb][4],
                                           float mul) {
  constexpr int LD = MmaBwd<D>::kLd;
  constexpr int CH = MmaBwd<D>::kChunks;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int db = 0; db < MmaBwd<D>::kDb; ++db) {
    *reinterpret_cast<uint32_t*>(stage + g * LD + db * 8 + 2 * t) =
        mma_bf16::pack_bf16x2(acc[db][0] * mul, acc[db][1] * mul);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + db * 8 + 2 * t) =
        mma_bf16::pack_bf16x2(acc[db][2] * mul, acc[db][3] * mul);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * CH / 32; ++i) {
    const int c = i * 32 + lane;
    const int r = c / CH, col = (c % CH) * 8;
    if (r0 + r < n) {
      *reinterpret_cast<uint4*>(out + (r0 + r) * stride + col) =
          *reinterpret_cast<const uint4*>(stage + r * LD + col);
    }
  }
}

// The A fragment (16 x 16, k = 16 columns of a 16-column block) of
// `kc` of a row-major C accumulator [.][4] of n-blocks 2 kc and 2 kc + 1,
// rounded to bf16: how P and dS reach the next product in registers.
template <int N>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[N][4],
                                       int kc) {
  a[0] = mma_bf16::pack_bf16x2(c[2 * kc][0], c[2 * kc][1]);
  a[1] = mma_bf16::pack_bf16x2(c[2 * kc][2], c[2 * kc][3]);
  a[2] = mma_bf16::pack_bf16x2(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = mma_bf16::pack_bf16x2(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

// P and the cap's factor 1 - t^2 of one score s (the raw q.k): with CAP,
// t = tanh(s cap_in), P = exp2(t cap_out - LSE log2(e)), cap_in = scale /
// softcap and cap_out = softcap log2(e); without, P = exp2(s scale log2(e)
// - LSE log2(e)) and the factor is 1.
template <bool CAP>
__device__ __forceinline__ float cap_p(float s, float scale_log2, float cap_in,
                                       float cap_out, float lse2, float& dcap) {
  if constexpr (CAP) {
    const float t = tanhf(s * cap_in);
    dcap = 1.f - t * t;
    return exp2f(fmaf(t, cap_out, -lse2));
  } else {
    dcap = 1.f;
    return exp2f(fmaf(s, scale_log2, -lse2));
  }
}

template <int D, bool WINDOW, bool CAP>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dq_bf16_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int sq, int skv,
    int heads, int kv_heads, int causal, int q_offset, int win_lo, float scale,
    float cap_in, float cap_out) {
  using namespace mma_bf16;
  using namespace ptx;
  constexpr int LD = MmaBwd<D>::kLd;
  constexpr int KC = MmaBwd<D>::kKc;
  constexpr int DB = MmaBwd<D>::kDb;
  constexpr int NS = MmaBwd<D>::kSub;
  constexpr int NB = NS / 8;              // n-blocks of S and dP
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][LD]
  __nv_bfloat16* dos = qs + MmaBwd<D>::kTile;                       // [64][LD]
  __nv_bfloat16* ks = dos + MmaBwd<D>::kTile;                       // [2][64][LD]
  __nv_bfloat16* vs = ks + 2 * MmaBwd<D>::kTile;                    // [2][64][LD]
  float* drow = reinterpret_cast<float*>(vs + 2 * MmaBwd<D>::kTile);  // [64]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                // C-fragment row (and row + 8)
  const int t = lane & 3;                 // C-fragment columns 2t, 2t + 1
  const int bi = blockIdx.x / heads;
  const int hi = blockIdx.x % heads;
  const int kvi = hi / (heads / kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaTile;
  const long long q_row = static_cast<long long>(heads) * D;
  const long long kv_row = static_cast<long long>(kv_heads) * D;
  const long long q_base = static_cast<long long>(bi) * sq * q_row +
                           static_cast<long long>(hi) * D;
  const long long kv_base = static_cast<long long>(bi) * skv * kv_row +
                            static_cast<long long>(kvi) * D;
  const long long row_base = (static_cast<long long>(bi) * heads + hi) * sq;

  copy_tile<D>(qs, q + q_base, q_row, q0, sq);
  copy_tile<D>(dos, dout + q_base, q_row, q0, sq);
  cp_async_commit();
  int kv_end = skv;
  if (causal) kv_end = min(skv, q0 + kMmaTile + q_offset);
  // The window: the loop starts at the tile of the block's first row's
  // first visible key; tiles reaching to or below the block's last row's
  // window edge are masked element by element.
  // With WINDOW, key j is hidden from row i when j <= i + win_lo
  // (win_lo = q_offset - window).
  int kv_begin = 0;
  if (WINDOW) kv_begin = max(0, q0 + win_lo + 1);
  const int tile_begin = kv_begin / kMmaTile;
  const int tile_end = (kv_end + kMmaTile - 1) / kMmaTile;
  const int window_edge = WINDOW ? q0 + kMmaTile - 1 + win_lo : -1;
  auto load_kv = [&](int tile, int stage) {
    copy_tile<D>(ks + stage * MmaBwd<D>::kTile, k + kv_base, kv_row,
                 tile * kMmaTile, skv);
    copy_tile<D>(vs + stage * MmaBwd<D>::kTile, v + kv_base, kv_row,
                 tile * kMmaTile, skv);
  };
  if (tile_begin < tile_end) load_kv(tile_begin, tile_begin & 1);
  cp_async_commit();
  cp_async_wait<1>();                     // Q and dO have landed
  __syncthreads();

  // D_i = dO_i . O_i in float32: two lanes a row, D/2 head dims each.
  {
    const int r = tid >> 1, half = tid & 1;
    const int row = q0 + r;
    float sum = 0.f;
    if (row < sq) {
      const __nv_bfloat16* op = o + q_base + row * q_row + half * (D / 2);
      const __nv_bfloat16* dp = dos + r * LD + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(op + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(dp + c);
        const __nv_bfloat162* oh = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* dh = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 a = __bfloat1622float2(dh[j]);
          const float2 b = __bfloat1622float2(oh[j]);
          sum = fmaf(a.x, b.x, sum);
          sum = fmaf(a.y, b.y, sum);
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      drow[r] = sum;
      if (row < sq) delta[row_base + row] = sum;
    }
  }
  __syncthreads();

  // dO's A fragments are held in registers, but for a masked instance at
  // D = 128, which reads them again from shared memory each tile: the
  // masks' and the cap's values would push it past 255 registers.
  constexpr bool HOLD_DO = D <= 64 || !(WINDOW || CAP);
  constexpr int HD = HOLD_DO ? KC : 1;
  uint32_t qf[KC][4], df[HD][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int off = (warp * 16 + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8;
    ldmatrix_x4(qf[kc], qs + off);
    if constexpr (HOLD_DO) ldmatrix_x4(df[kc], dos + off);
  }
  const int r0 = warp * 16 + g;           // tile rows r0 and r0 + 8
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    lse2[r] = row < sq ? lse[row_base + row] * kLog2e : 0.f;
    dd[r] = drow[r0 + 8 * r];
  }
  const float scale_log2 = scale * kLog2e;
  float acc[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[db][e] = 0.f;
  }

  for (int it = tile_begin; it < tile_end; ++it) {
    if (it + 1 < tile_end) load_kv(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();                   // tile `it` has landed
    __syncthreads();
    const __nv_bfloat16* kt = ks + (it & 1) * MmaBwd<D>::kTile;
    const __nv_bfloat16* vt = vs + (it & 1) * MmaBwd<D>::kTile;
    const int t0 = it * kMmaTile;
    const bool edge = t0 + kMmaTile > skv ||
                      (causal && t0 + kMmaTile - 1 > q0 + q_offset) ||
                      (WINDOW && t0 <= window_edge);
#pragma unroll
    for (int sub = 0; sub < kMmaTile; sub += NS) {
      // S = Q.K^T and dP = dO.V^T, K and V as n-major B fragments.
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
      }
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t da[4];                   // dO's fragment, when not held
        if constexpr (!HOLD_DO) {
          ldmatrix_x4(da, dos + (warp * 16 + (lane & 15)) * LD + kc * 16 +
                              (lane >> 4) * 8);
        }
#pragma unroll
        for (int nb = 0; nb < NB; nb += 2) {
          const int off = (sub + nb * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                          kc * 16 + ((lane >> 3) & 1) * 8;
          uint32_t b[4];
          ldmatrix_x4(b, kt + off);
          mma_bf16_16816(s[nb], qf[kc], b[0], b[1]);
          mma_bf16_16816(s[nb + 1], qf[kc], b[2], b[3]);
          ldmatrix_x4(b, vt + off);
          if constexpr (HOLD_DO) {
            mma_bf16_16816(dp[nb], df[kc], b[0], b[1]);
            mma_bf16_16816(dp[nb + 1], df[kc], b[2], b[3]);
          } else {
            mma_bf16_16816(dp[nb], da, b[0], b[1]);
            mma_bf16_16816(dp[nb + 1], da, b[2], b[3]);
          }
        }
      }
      // P = exp2(cap(S scale) log2(e) - LSE log2(e)), 0 where masked (only
      // on tiles that cross the diagonal, the window's edge or the end of
      // the keys), and dS = P (dP - D) (1 - t^2), in the C registers.
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t0 + sub + nb * 8 + 2 * t + (e & 1);
          const int row = q0 + r0 + (e >> 1) * 8;
          const bool hidden = key >= skv || (causal && key > row + q_offset) ||
                              (WINDOW && key <= row + win_lo);
          float dcap = 1.f;
          const float p = edge && hidden
              ? 0.f : cap_p<CAP>(s[nb][e], scale_log2, cap_in, cap_out, lse2[e >> 1],
                                 dcap);
          s[nb][e] = p * (dp[nb][e] - dd[e >> 1]) * dcap;
        }
      }
      // dQ += dS.K: dS rounded to bf16 A fragments in registers, K as a
      // k-major B fragment (ldmatrix.trans).
#pragma unroll
      for (int kc = 0; kc < NS / 16; ++kc) {
        uint32_t a[4];
        c_to_a(a, s, kc);
#pragma unroll
        for (int db = 0; db < DB; db += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, kt + (sub + kc * 16 + (lane & 15)) * LD + db * 8 +
                                   (lane >> 4) * 8);
          mma_bf16_16816(acc[db], a, b[0], b[1]);
          mma_bf16_16816(acc[db + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();                      // the next load refills this stage
  }
  // dQ = scale * sum, through the warp's own Q rows.
  store_rows<D>(dq + q_base, q_row, q0 + warp * 16, sq, qs + warp * 16 * LD, acc,
                scale);
}

template <int D, bool WINDOW, bool CAP>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dkdv_bf16_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int sq,
    int skv, int heads, int kv_heads, int causal, int q_offset, int win_lo,
    float scale, float cap_in, float cap_out) {
  using namespace mma_bf16;
  using namespace ptx;
  constexpr int LD = MmaBwd<D>::kLd;
  constexpr int KC = MmaBwd<D>::kKc;
  constexpr int DB = MmaBwd<D>::kDb;
  constexpr int NS = MmaBwd<D>::kSub;
  constexpr int NB = NS / 8;              // n-blocks of S^T and dP^T
  constexpr bool HOLD = MmaBwd<D>::kHoldKv;
  constexpr int HK = HOLD ? KC : 1;       // K and V fragments held
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][LD]
  __nv_bfloat16* vs = ks + MmaBwd<D>::kTile;                        // [64][LD]
  __nv_bfloat16* qs = vs + MmaBwd<D>::kTile;                        // [2][64][LD]
  __nv_bfloat16* dos = qs + 2 * MmaBwd<D>::kTile;                   // [2][64][LD]
  float* ls = reinterpret_cast<float*>(dos + 2 * MmaBwd<D>::kTile);  // [2][64] LSE
  float* dl = ls + 2 * kMmaTile;                                    // [2][64] D

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bi = blockIdx.x / kv_heads;
  const int kvi = blockIdx.x % kv_heads;
  const int k0 = blockIdx.y * kMmaTile;
  const int rep = heads / kv_heads;
  const long long q_row = static_cast<long long>(heads) * D;
  const long long kv_row = static_cast<long long>(kv_heads) * D;
  const long long kv_base = static_cast<long long>(bi) * skv * kv_row +
                            static_cast<long long>(kvi) * D;

  copy_tile<D>(ks, k + kv_base, kv_row, k0, skv);
  copy_tile<D>(vs, v + kv_base, kv_row, k0, skv);
  cp_async_commit();
  // Query tiles wholly below the causal mask (every row's last key before
  // k0) or past the window (every row's first key after the tile's last)
  // are skipped.  The walk is every query tile from q_begin up to q_end of
  // every query head of the kv head's group, one ring slot a tile.
  int q_begin = 0;
  if (causal) q_begin = max(0, k0 - q_offset) / kMmaTile * kMmaTile;
  int q_end = sq;
  if (WINDOW) q_end = min(sq, max(0, k0 + kMmaTile - 1 - win_lo));
  const int n_q = q_begin < q_end ? (q_end - q_begin + kMmaTile - 1) / kMmaTile : 0;
  const int n_tiles = rep * n_q;
  auto load_q = [&](int it, int stage) {
    const int hi = kvi * rep + it / n_q;
    const int q0 = q_begin + (it % n_q) * kMmaTile;
    const long long q_base = static_cast<long long>(bi) * sq * q_row +
                             static_cast<long long>(hi) * D;
    const long long row_base = (static_cast<long long>(bi) * heads + hi) * sq;
    copy_tile<D>(qs + stage * MmaBwd<D>::kTile, q + q_base, q_row, q0, sq);
    copy_tile<D>(dos + stage * MmaBwd<D>::kTile, dout + q_base, q_row, q0, sq);
    // One float a thread: the 64 rows' LSE, then their D.
    const int r = tid & (kMmaTile - 1);
    const bool in = q0 + r < sq;
    const float* src = tid < kMmaTile ? lse : delta;
    float* dst = tid < kMmaTile ? ls : dl;
    cp_async_4(dst + stage * kMmaTile + r, src + row_base + (in ? q0 + r : 0),
               in ? 4 : 0);
  };
  if (n_tiles > 0) load_q(0, 0);
  cp_async_commit();
  cp_async_wait<1>();                     // K and V have landed
  __syncthreads();

  const int a_off = (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  uint32_t kf[HK][4], vf[HK][4];
  if constexpr (HOLD) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      ldmatrix_x4(kf[kc], ks + a_off + kc * 16);
      ldmatrix_x4(vf[kc], vs + a_off + kc * 16);
    }
  }
  float adk[DB][4], adv[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db) {
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[db][e] = adv[db][e] = 0.f;
  }
  const int key0 = k0 + warp * 16 + g;    // this lane's keys key0, key0 + 8
  const float scale_log2 = scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_q(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();                   // tile `it` has landed
    __syncthreads();
    const __nv_bfloat16* qt = qs + (it & 1) * MmaBwd<D>::kTile;
    const __nv_bfloat16* dt = dos + (it & 1) * MmaBwd<D>::kTile;
    const float* lt = ls + (it & 1) * kMmaTile;
    const float* dlt = dl + (it & 1) * kMmaTile;
    const int q0 = q_begin + (it % n_q) * kMmaTile;
    const bool edge = k0 + kMmaTile > skv || q0 + kMmaTile > sq ||
                      (causal && k0 + kMmaTile - 1 > q0 + q_offset) ||
                      (WINDOW && k0 <= q0 + kMmaTile - 1 + win_lo);
#pragma unroll
    for (int sub = 0; sub < kMmaTile; sub += NS) {
      // S^T = K.Q^T and dP^T = V.dO^T, Q and dO as n-major B fragments.
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
      }
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t ka[4], va[4];
        if constexpr (HOLD) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            ka[x] = kf[kc][x];
            va[x] = vf[kc][x];
          }
        } else {
          ldmatrix_x4(ka, ks + a_off + kc * 16);
          ldmatrix_x4(va, vs + a_off + kc * 16);
        }
#pragma unroll
        for (int nb = 0; nb < NB; nb += 2) {
          const int off = (sub + nb * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                          kc * 16 + ((lane >> 3) & 1) * 8;
          uint32_t b[4];
          ldmatrix_x4(b, qt + off);
          mma_bf16_16816(s[nb], ka, b[0], b[1]);
          mma_bf16_16816(s[nb + 1], ka, b[2], b[3]);
          ldmatrix_x4(b, dt + off);
          mma_bf16_16816(dp[nb], va, b[0], b[1]);
          mma_bf16_16816(dp[nb + 1], va, b[2], b[3]);
        }
      }
      // P^T and dS^T = P^T (dP^T - D) (1 - t^2) in the C registers: a
      // column is a query row, whose LSE and D come from the ring's small
      // arrays.
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int col = sub + nb * 8 + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lt + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dlt + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + col + (e & 1);
          const int key = key0 + (e >> 1) * 8;
          const bool hidden = row >= sq || key >= skv ||
                              (causal && key > row + q_offset) ||
                              (WINDOW && key <= row + win_lo);
          const float lrow = (e & 1) ? l2.y : l2.x;
          const float drw = (e & 1) ? d2.y : d2.x;
          float dcap = 1.f;
          const float p = edge && hidden
              ? 0.f : cap_p<CAP>(s[nb][e], scale_log2, cap_in, cap_out,
                                 lrow * kLog2e, dcap);
          s[nb][e] = p;
          dp[nb][e] = p * (dp[nb][e] - drw) * dcap;
        }
      }
      // dV += P^T.dO and dK += dS^T.Q: P^T and dS^T rounded to bf16 A
      // fragments in registers, dO and Q as k-major B fragments.
#pragma unroll
      for (int kc = 0; kc < NS / 16; ++kc) {
        uint32_t ap[4], as[4];
        c_to_a(ap, s, kc);
        c_to_a(as, dp, kc);
#pragma unroll
        for (int db = 0; db < DB; db += 2) {
          const int off = (sub + kc * 16 + (lane & 15)) * LD + db * 8 + (lane >> 4) * 8;
          uint32_t b[4];
          ldmatrix_x4_trans(b, dt + off);
          mma_bf16_16816(adv[db], ap, b[0], b[1]);
          mma_bf16_16816(adv[db + 1], ap, b[2], b[3]);
          ldmatrix_x4_trans(b, qt + off);
          mma_bf16_16816(adk[db], as, b[0], b[1]);
          mma_bf16_16816(adk[db + 1], as, b[2], b[3]);
        }
      }
    }
    __syncthreads();                      // the next load refills this stage
  }
  // dK = scale * sum and dV, through the warp's own K and V rows.
  store_rows<D>(dk + kv_base, kv_row, k0 + warp * 16, skv, ks + warp * 16 * LD, adk,
                scale);
  store_rows<D>(dv + kv_base, kv_row, k0 + warp * 16, skv, vs + warp * 16 * LD, adv,
                1.f);
}

template <int D, bool WINDOW, bool CAP>
int launch_bwd_mma(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* delta, void* dq,
                   void* dk, void* dv, int b, int sq, int skv, int heads,
                   int kv_heads, int causal, int q_offset, int window,
                   float softcap, float scale, cudaStream_t stream) {
  constexpr int kDqSmem = MmaBwd<D>::kDqSmemBytes;
  constexpr int kKvSmem = MmaBwd<D>::kDkdvSmemBytes;
  static int granted_dq[host_launch::kMaxDevices] = {};
  static int granted_kv[host_launch::kMaxDevices] = {};
  cudaError_t err = host_launch::opt_in(flash_bwd_dq_bf16_mma<D, WINDOW, CAP>,
                                        granted_dq, kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = host_launch::opt_in(flash_bwd_dkdv_bf16_mma<D, WINDOW, CAP>, granted_kv,
                            kKvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf16 = __nv_bfloat16;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const float* lt = static_cast<const float*>(lse);
  float* dt = static_cast<float*>(delta);
  const float cap_in = CAP ? scale / softcap : 0.f;
  const float cap_out = softcap * kLog2e;
  flash_bwd_dq_bf16_mma<D, WINDOW, CAP>
      <<<dim3(b * heads, (sq + kMmaTile - 1) / kMmaTile), kMmaThreads, kDqSmem,
         stream>>>(qt, kt, vt, static_cast<const bf16*>(o), dot, lt, dt,
                   static_cast<bf16*>(dq), sq, skv, heads, kv_heads, causal, q_offset,
                   q_offset - window, scale, cap_in, cap_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_bf16_mma<D, WINDOW, CAP>
      <<<dim3(b * kv_heads, (skv + kMmaTile - 1) / kMmaTile), kMmaThreads, kKvSmem,
         stream>>>(qt, kt, vt, dot, lt, dt, static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), sq, skv, heads, kv_heads, causal, q_offset,
                   q_offset - window, scale, cap_in, cap_out);
  return static_cast<int>(cudaGetLastError());
}

template <bool WINDOW, bool CAP>
int launch_bwd_mma_d(int d, const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const void* lse, void* delta,
                     void* dq, void* dk, void* dv, int b, int sq, int skv,
                     int heads, int kv_heads, int causal, int q_offset, int window,
                     float softcap, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch_bwd_mma<16, WINDOW, CAP>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, heads, kv_heads, causal, q_offset, window, softcap, scale, s);
    case 32: return launch_bwd_mma<32, WINDOW, CAP>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, heads, kv_heads, causal, q_offset, window, softcap, scale, s);
    case 64: return launch_bwd_mma<64, WINDOW, CAP>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, heads, kv_heads, causal, q_offset, window, softcap, scale, s);
    case 128: return launch_bwd_mma<128, WINDOW, CAP>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, heads, kv_heads, causal, q_offset, window, softcap, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bfloat16 pair's instance for the call's masks: a window (window > 0)
// and a cap (softcap > 0) each a template flag.
int launch_bwd_mma_masks(int d, const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const void* lse,
                         void* delta, void* dq, void* dk, void* dv, int b, int sq,
                         int skv, int heads, int kv_heads, int causal, int q_offset,
                         int window, float softcap, float scale, cudaStream_t s) {
  if (window > 0 && softcap > 0.f) {
    return launch_bwd_mma_d<true, true>(d, q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, heads, kv_heads, causal, q_offset, window, softcap, scale, s);
  }
  if (window > 0) {
    return launch_bwd_mma_d<true, false>(d, q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, heads, kv_heads, causal, q_offset, window, softcap, scale, s);
  }
  if (softcap > 0.f) {
    return launch_bwd_mma_d<false, true>(d, q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, heads, kv_heads, causal, q_offset, window, softcap, scale, s);
  }
  return launch_bwd_mma_d<false, false>(d, q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, heads, kv_heads, causal, q_offset, window, softcap, scale, s);
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

template <int D>
int mma_smem_bytes(int dkdv) {
  return dkdv ? MmaBwd<D>::kDkdvSmemBytes : MmaBwd<D>::kDqSmemBytes;
}

int bwd_mma_smem_bytes(int d, int dkdv) {
  switch (d) {
    case 16: return mma_smem_bytes<16>(dkdv);
    case 32: return mma_smem_bytes<32>(dkdv);
    case 64: return mma_smem_bytes<64>(dkdv);
    case 128: return mma_smem_bytes<128>(dkdv);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  delta is
// a float32 (b, heads, sq) scratch that the dq pass writes and the dk/dv
// pass reads.  window 0 and softcap 0 mean none.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int b, int sq, int skv, int heads, int kv_heads, int d,
    int dtype, int causal, int q_offset, int window, float softcap, float scale,
    int device, void* stream) {
  const host_launch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (window < 0 || !(softcap >= 0.f)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    return launch_bwd_d<float>(d, q, k, v, o, dout, lse, delta, dq, dk, dv, b,
                               sq, skv, heads, kv_heads, causal, q_offset, window,
                               softcap, scale, s);
  }
  if (dtype == 1) {
    return launch_bwd_mma_masks(d, q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq,
                                skv, heads, kv_heads, causal, q_offset, window,
                                softcap, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of both float32 backward kernels for head dim d
// (-1: none).
extern "C" int flash_attention_bwd_smem_bytes(int d) { return bwd_smem_bytes(d); }

// Dynamic shared memory of the bfloat16 dq pass (dkdv = 0) or dk/dv pass
// (dkdv = 1) for head dim d (-1: none).
extern "C" int flash_attention_bwd_bf16_smem_bytes(int d, int dkdv) {
  return bwd_mma_smem_bytes(d, dkdv);
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
