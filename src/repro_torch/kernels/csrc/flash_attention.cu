// Flash attention (online softmax, grouped K/V heads) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention.py (entry `flash_attention`).
//
//   o[b, i, h, :] = sum_j softmax_j(s_ij) * v[b, j, h / rep, :],
//   s_ij = cap((q[b, i, h, :] . k[b, j, h / rep, :]) * scale),  rep = H / KVH,
//   cap(x) = softcap * tanh(x / softcap)  (x itself when softcap = 0),
//
// with s_ij = -1e30 where a mask hides key j from query i and for keys
// past the sequence: the causal mask (j > i + q_offset) and, when
// window > 0, the sliding window (j <= i + q_offset - window, causal or
// not), after the softcap, as the reference's model attention
// (src/repro/models/attention.py, naive_attention) computes them; the
// Pallas kernel itself knows only the causal mask.  q is (b, sq, H, D),
// k and v (b, skv, KVH, D), o (b, sq, H, D), all contiguous, 16-byte
// aligned, and all float32 or all bfloat16.  Query head h reads kv head
// h / rep, so grouped-query attention needs no repeated K/V; the TPU
// kernel's equal-heads case is rep = 1.  The running max, the denominator
// and the accumulator are float32 (the Pallas kernel's VMEM scratch
// becomes registers), the denominator is clamped at 1e-30 as in its
// `_finalize`, and the output is rounded once to the input type.  The type
// picks one of two kernels:
//  * bfloat16: `flash_fwd_bf16_mma`, on the tensor cores;
//  * float32: `flash_fwd`, on the CUDA cores in full float32 (no
//    reduced-precision tensor-core shortcut: the port holds this route to
//    1e-5 of its plain version).
//
// What bounds it on this card.  The work is 4*D operations for each
// (query, key) pair the masks keep (4*b*H*sq*skv*D unmasked, about half
// under the causal mask, at most w keys a row under a window of w) against
// (2*b*sq*H + 2*b*skv*KVH)*D elements moved, so at the LM paths' shapes
// (D = 64, s = 1024 or 4096) it is bound by operations: 8.6 GFLOP a launch at Granite's b = 4, H = 16, s = 1024,
// 8.7 us at the tensor cores' 989 TFLOP/s bf16, and 0.139 ms at Zamba2's
// b = 2, H = 32, s = 4096.  Float32 has only the CUDA cores (67 TFLOP/s),
// a floor some 15x higher.
//
// Design of the bfloat16 kernel (PTX wrappers in mma_bf16.cuh).
//  * One block of 4 warps per (b*H, tile of 64 query rows); each warp owns
//    16 query rows, one mma row block.  The Q tile is copied to shared
//    memory once and held in registers as A fragments (ldmatrix).
//  * K and V tiles of 64 keys are copied by cp.async into a 2-stage ring
//    of shared memory, the next tile's copy in flight while this one is
//    used.  Rows are padded by 16 bytes, so ldmatrix's eight row addresses
//    fall in distinct banks.  Keys past skv are zero-filled and masked.
//  * S = Q.K^T by mma.sync m16n8k16 (bf16 in, float32 accumulators).
//    Then, in registers: the scale (times log2(e), so exp2f gives the
//    exponentials), the -1e30 mask (only on tiles that cross the diagonal,
//    the window's lower edge or the end of the keys) and the online softmax; a row's max and sum
//    are spread over the four lanes of a quad and take two
//    __shfl_xor_sync each.
//  * O += P.V by mma: P is rounded to bf16 in registers and reused as the
//    A fragment, V is read with ldmatrix.trans; P never goes through
//    shared memory.  The denominator sums the float32 P.
//  * Numerics: one deliberate difference from the TPU kernel, which keeps
//    P in float32 for P.V: here P is rounded to bf16 first (2^-9 relative
//    per probability), as the reference model's own attention
//    (src/repro/models/attention.py) rounds its probabilities to the
//    compute type.  The output is divided by the clamped denominator
//    (IEEE division), rounded once to bf16, staged through the warp's own
//    rows of the Q tile and stored in 16-byte chunks, masked past sq.
//  * Causal: key tiles wholly above the block's last query are never
//    loaded.  Query tiles are issued heaviest first (grid y reversed), so
//    the long causal rows do not trail at the end of the launch.
//  * Window: the key loop starts at the tile holding the block's first
//    row's first visible key, max(0, q0 + q_offset - window + 1); tiles
//    that reach below the block's last row's window are masked element by
//    element.  A late row of the block can find its first tiles wholly
//    hidden: its running max stays -1e30 and each hidden key adds
//    p = exp2(0) = 1 to its sums, until its first visible key brings a real
//    max m and the rescale by exp2(-1e30 - m) = 0 clears them.  So no tile
//    skips the rescale.  A row that sees no key at all never gets that
//    rescale; the wrapper refuses such a call.
//  * Softcap: cap(s * scale) in float32 with tanhf (no approximate tanh),
//    then the log2(e) factor; without a softcap the two factors stay
//    folded into one multiply.
//  * Shared memory is (64 + 4 * 64) rows of D + 8 bf16: 46 KB at D = 64,
//    87 KB at D = 128, taken as dynamic shared memory.
//
// Design of the float32 kernel.
//  * One block of 128 threads per (b*H, tile of query rows).  A query row
//    belongs to D/16 consecutive lanes, each holding 16 of its D values of
//    q and of the accumulator in registers; a dot product is summed over
//    those lanes with xor shuffles, which give every lane the same sum.
//  * K and V tiles of BKV keys are staged through shared memory as
//    float32, read from device memory in 16-byte loads; the scores of
//    one tile stay in registers while the running max, the denominator and
//    the accumulator are rescaled once per tile.
//  * Causal: key tiles wholly above the block's last query are never
//    loaded (the `pl.when` skip of flash_attention.py:46-48); inside the
//    diagonal tile keys are masked per row.  A window starts the key loop
//    at the tile of the block's first visible key, as in the bfloat16
//    kernel, and masks per row; the softcap is applied with tanhf.
//  * Any sq and skv: rows past sq compute and are not stored, keys past skv
//    are zero-filled and masked (the Pallas kernel asserts divisibility).
//  * expf, fmaf and IEEE division: no fast-math intrinsics.
//
// Log-sum-exp.  Given a non-null `lse` (training: the autograd path of
// kernels/flash_attention.py), each kernel also writes every row's float32
// log-sum-exp of its scores, m + log(l) in natural-log units (the bfloat16
// kernel's running max is in log2 units and is converted), (b, H, sq); the
// backward kernels (flash_attention_bwd.cu) recompute P = exp(s - lse)
// from it.  Inference passes null, and nothing else changes.
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

constexpr int kThreads = 128;
constexpr int kSeg = 16;              // head dims per lane
constexpr float kNegInf = -1.0e30f;   // the Pallas kernel's NEG_INF

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

template <int D>
struct Tile {
  static constexpr int kLanes = D / kSeg;             // lanes per query row
  static constexpr int kRows = kThreads / kLanes;     // query rows per block
  static constexpr int kKeys = 4096 / D < 64 ? 4096 / D : 64;  // keys a tile
  static_assert(D % kSeg == 0 && 32 % kLanes == 0, "D in {16, 32, 64, 128}");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int sq, int skv, int heads,
    int kv_heads, int causal, int q_offset, int window, float softcap,
    float scale) {
  constexpr int G = Tile<D>::kLanes;
  constexpr int BQ = Tile<D>::kRows;
  constexpr int BKV = Tile<D>::kKeys;
  __shared__ __align__(16) float ks[BKV][D];
  __shared__ __align__(16) float vs[BKV][D];

  const int tid = threadIdx.x;
  const int seg = (tid % G) * kSeg;   // this lane's head dims seg .. seg+15
  const int bi = blockIdx.y / heads;
  const int hi = blockIdx.y % heads;
  const int kvi = hi / (heads / kv_heads);
  const int q0 = blockIdx.x * BQ;
  const int qi = q0 + tid / G;
  const bool live = qi < sq;
  const long long q_row = static_cast<long long>(heads) * D;
  const long long kv_row = static_cast<long long>(kv_heads) * D;

  constexpr int VN = Vec<T>::kN;
  static_assert(BKV * D % (kThreads * VN) == 0, "whole 16-byte loads a tile");
  float qr[kSeg], acc[kSeg];
  const T* qp = q + (static_cast<long long>(bi) * sq + (live ? qi : 0)) * q_row +
                static_cast<long long>(hi) * D + seg;
#pragma unroll
  for (int c = 0; c < kSeg; c += VN) Vec<T>::load(qp + c, qr + c);
#pragma unroll
  for (int c = 0; c < kSeg; ++c) {
    if (!live) qr[c] = 0.f;
    acc[c] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const int qpos = qi + q_offset;

  int kv_end = skv;
  if (causal) kv_end = min(skv, max(0, q0 + BQ + q_offset));
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 + q_offset - window + 1) / BKV * BKV;
  const T* kb = k + static_cast<long long>(bi) * skv * kv_row +
                static_cast<long long>(kvi) * D;
  const T* vb = v + static_cast<long long>(bi) * skv * kv_row +
                static_cast<long long>(kvi) * D;

  for (int t0 = kv_begin; t0 < kv_end; t0 += BKV) {
    __syncthreads();                  // the previous tile has been read
    // 16-byte loads, all of a thread's issued before the first is used.
#pragma unroll
    for (int it = 0; it < BKV * D / (kThreads * VN); ++it) {
      const int e = (it * kThreads + tid) * VN;
      const int j = e / D, c = e % D;
      const int key = t0 + j;
      float kx[VN], vx[VN];
      if (key < skv) {
        Vec<T>::load(kb + key * kv_row + c, kx);
        Vec<T>::load(vb + key * kv_row + c, vx);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) kx[i] = vx[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VN; ++i) {
        ks[j][c + i] = kx[i];
        vs[j][c + i] = vx[i];
      }
    }
    __syncthreads();

    float s[BKV];
    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(&ks[j][seg]);
      float dot = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < kSeg / 4; ++c4) {
        const float4 kx = kr[c4];
        dot = fmaf(qr[4 * c4 + 0], kx.x, dot);
        dot = fmaf(qr[4 * c4 + 1], kx.y, dot);
        dot = fmaf(qr[4 * c4 + 2], kx.z, dot);
        dot = fmaf(qr[4 * c4 + 3], kx.w, dot);
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      }
      const int key = t0 + j;
      const bool seen = key < skv && (!causal || key <= qpos) &&
                        (window <= 0 || key > qpos - window);
      float sc = dot * scale;
      if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
      s[j] = seen ? sc : kNegInf;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < kSeg; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(&vs[j][seg]);
#pragma unroll
      for (int c4 = 0; c4 < kSeg / 4; ++c4) {
        const float4 vx = vr[c4];
        acc[4 * c4 + 0] = fmaf(p, vx.x, acc[4 * c4 + 0]);
        acc[4 * c4 + 1] = fmaf(p, vx.y, acc[4 * c4 + 1]);
        acc[4 * c4 + 2] = fmaf(p, vx.z, acc[4 * c4 + 2]);
        acc[4 * c4 + 3] = fmaf(p, vx.w, acc[4 * c4 + 3]);
      }
    }
    m = m_new;
  }

  if (!live) return;
  const float denom = fmaxf(l, 1e-30f);
  // Every lane of the row holds the same m and l.
  if (lse != nullptr && tid % G == 0) {
    lse[(static_cast<long long>(bi) * heads + hi) * sq + qi] = m + logf(denom);
  }
  T* op = o + (static_cast<long long>(bi) * sq + qi) * q_row +
          static_cast<long long>(hi) * D + seg;
#pragma unroll
  for (int c = 0; c < kSeg; ++c) store(op + c, acc[c] / denom);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int sq, int skv, int heads, int kv_heads, int causal,
           int q_offset, int window, float softcap, float scale,
           cudaStream_t stream) {
  const dim3 grid((sq + Tile<D>::kRows - 1) / Tile<D>::kRows, b * heads);
  flash_fwd<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, skv, heads,
      kv_heads, causal, q_offset, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             float* lse, int b, int sq, int skv, int heads, int kv_heads, int causal,
             int q_offset, int window, float softcap, float scale,
             cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, b, sq, skv, heads, kv_heads, causal, q_offset, window, softcap, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, b, sq, skv, heads, kv_heads, causal, q_offset, window, softcap, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, b, sq, skv, heads, kv_heads, causal, q_offset, window, softcap, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, b, sq, skv, heads, kv_heads, causal, q_offset, window, softcap, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// -- bfloat16: tensor cores ----------------------------------------------------

constexpr int kMmaRows = 64;          // query rows a block: 16 per warp
constexpr int kMmaKeys = 64;          // keys a K/V tile
constexpr int kMmaThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct MmaTile {
  static constexpr int kLd = D + 8;   // bf16 a shared row: 16 bytes of padding
  static constexpr int kChunks = D / 8;  // 16-byte chunks a row
  static constexpr int kSmemBytes =
      (kMmaRows + 2 * 2 * kMmaKeys) * kLd * static_cast<int>(sizeof(__nv_bfloat16));
  static_assert(D % 16 == 0 && D <= 128, "D in {16, 32, 64, 128}");
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_bf16_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int sq, int skv, int heads, int kv_heads,
    int causal, int q_offset, int window, float softcap, float scale) {
  using namespace mma_bf16;
  using namespace ptx;
  constexpr int LD = MmaTile<D>::kLd;
  constexpr int CH = MmaTile<D>::kChunks;
  constexpr int KC = D / 16;              // k steps of Q.K^T
  constexpr int NB = kMmaKeys / 8;        // n-blocks of S (8 keys each)
  constexpr int DB = D / 8;               // n-blocks of O (8 head dims each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][LD]
  __nv_bfloat16* ks = qs + kMmaRows * LD;                           // [2][64][LD]
  __nv_bfloat16* vs = ks + 2 * kMmaKeys * LD;                       // [2][64][LD]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                // C-fragment row (and row + 8)
  const int t = lane & 3;                 // C-fragment columns 2t, 2t + 1
  const int bi = blockIdx.x / heads;
  const int hi = blockIdx.x % heads;
  const int kvi = hi / (heads / kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaRows;
  const long long q_row = static_cast<long long>(heads) * D;
  const long long kv_row = static_cast<long long>(kv_heads) * D;
  const __nv_bfloat16* qb = q + static_cast<long long>(bi) * sq * q_row +
                            static_cast<long long>(hi) * D;
  const __nv_bfloat16* kb = k + static_cast<long long>(bi) * skv * kv_row +
                            static_cast<long long>(kvi) * D;
  const __nv_bfloat16* vb = v + static_cast<long long>(bi) * skv * kv_row +
                            static_cast<long long>(kvi) * D;

  static_assert(kMmaRows * CH % kMmaThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < kMmaRows * CH / kMmaThreads; ++i) {
    const int c = i * kMmaThreads + tid;
    const int r = c / CH, col = (c % CH) * 8;
    const bool in = q0 + r < sq;
    cp_async_16(qs + r * LD + col, qb + (in ? (q0 + r) * q_row : 0) + col, in ? 16 : 0);
  }
  cp_async_commit();

  int kv_end = skv;
  if (causal) kv_end = min(skv, q0 + kMmaRows + q_offset);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 + q_offset - window + 1);
  const int tile_begin = kv_begin / kMmaKeys;
  const int tile_end = (kv_end + kMmaKeys - 1) / kMmaKeys;
  // Keys at or below this one are hidden from the block's last row.
  const int window_edge = window > 0 ? q0 + kMmaRows - 1 + q_offset - window : -1;
  const float scale_log2 = scale * kLog2e;
  auto load_kv = [&](int tile, int stage) {
    const int t0 = tile * kMmaKeys;
    __nv_bfloat16* kd = ks + stage * kMmaKeys * LD;
    __nv_bfloat16* vd = vs + stage * kMmaKeys * LD;
#pragma unroll
    for (int i = 0; i < kMmaKeys * CH / kMmaThreads; ++i) {
      const int c = i * kMmaThreads + tid;
      const int r = c / CH, col = (c % CH) * 8;
      const bool in = t0 + r < skv;
      const long long off = (in ? (t0 + r) * kv_row : 0) + col;
      cp_async_16(kd + r * LD + col, kb + off, in ? 16 : 0);
      cp_async_16(vd + r * LD + col, vb + off, in ? 16 : 0);
    }
  };
  if (tile_begin < tile_end) load_kv(tile_begin, tile_begin & 1);
  cp_async_commit();
  cp_async_wait<1>();                     // the Q tile has landed
  __syncthreads();

  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    ldmatrix_x4(qf[kc], qs + (warp * 16 + (lane & 15)) * LD + kc * 16 +
                            (lane >> 4) * 8);
  }
  float acc[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[db][e] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};        // rows row0 and row0 + 8
  float l[2] = {0.f, 0.f};                // this lane's part of the sum
  const int row0 = q0 + warp * 16 + g;

  for (int it = tile_begin; it < tile_end; ++it) {
    if (it + 1 < tile_end) load_kv(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();                   // tile `it` has landed
    __syncthreads();
    const __nv_bfloat16* kt = ks + (it & 1) * kMmaKeys * LD;
    const __nv_bfloat16* vt = vs + (it & 1) * kMmaKeys * LD;

    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, kt + (nb * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                           kc * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16_16816(s[nb], qf[kc], b[0], b[1]);
        mma_bf16_16816(s[nb + 1], qf[kc], b[2], b[3]);
      }
    }

    const int t0 = it * kMmaKeys;
    const bool edge = t0 + kMmaKeys > skv ||
                      (causal && t0 + kMmaKeys - 1 > q0 + q_offset) ||
                      t0 <= window_edge;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + nb * 8 + 2 * t + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        const bool hidden = key >= skv || (causal && key > row + q_offset) ||
                            (window > 0 && key <= row + q_offset - window);
        const float x = softcap > 0.f
            ? tanhf(s[nb][e] * scale / softcap) * softcap * kLog2e
            : s[nb][e] * scale_log2;
        s[nb][e] = edge && hidden ? kNegInf : x;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        mx = fmaxf(mx, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        s[nb][2 * r] = exp2f(s[nb][2 * r] - mx);
        s[nb][2 * r + 1] = exp2f(s[nb][2 * r + 1] - mx);
        sum += s[nb][2 * r] + s[nb][2 * r + 1];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int db = 0; db < DB; ++db) {
        acc[db][2 * r] *= alpha;
        acc[db][2 * r + 1] *= alpha;
      }
    }

#pragma unroll
    for (int kc = 0; kc < kMmaKeys / 16; ++kc) {
      const uint32_t a[4] = {pack_bf16x2(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16x2(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int db = 0; db < DB; db += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vt + (kc * 16 + (lane & 15)) * LD + db * 8 +
                                 (lane >> 4) * 8);
        mma_bf16_16816(acc[db], a, b[0], b[1]);
        mma_bf16_16816(acc[db + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();                      // the next load refills this stage
  }

  // Finalize: quad sums of the denominators, IEEE division, one rounding
  // to bf16 into the warp's own Q rows, then 16-byte stores.
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    denom[r] = fmaxf(sum, 1e-30f);
  }
  // The row's log-sum-exp in natural-log units: m is in log2 units.
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < sq) {
        lse[(static_cast<long long>(bi) * heads + hi) * sq + row] =
            (m[r] + log2f(denom[r])) * kLn2;
      }
    }
  }
  __nv_bfloat16* os = qs + warp * 16 * LD;
#pragma unroll
  for (int db = 0; db < DB; ++db) {
    *reinterpret_cast<uint32_t*>(os + g * LD + db * 8 + 2 * t) =
        pack_bf16x2(acc[db][0] / denom[0], acc[db][1] / denom[0]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * LD + db * 8 + 2 * t) =
        pack_bf16x2(acc[db][2] / denom[1], acc[db][3] / denom[1]);
  }
  __syncwarp();
  __nv_bfloat16* ob = o + static_cast<long long>(bi) * sq * q_row +
                      static_cast<long long>(hi) * D;
#pragma unroll
  for (int i = 0; i < 16 * CH / 32; ++i) {
    const int c = i * 32 + lane;
    const int r = c / CH, col = (c % CH) * 8;
    const int row = q0 + warp * 16 + r;
    if (row < sq) {
      *reinterpret_cast<uint4*>(ob + row * q_row + col) =
          *reinterpret_cast<const uint4*>(os + r * LD + col);
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int b, int sq, int skv, int heads, int kv_heads, int causal,
               int q_offset, int window, float softcap, float scale,
               cudaStream_t stream) {
  constexpr int kSmem = MmaTile<D>::kSmemBytes;
  // More than the default 48 KB of dynamic shared memory: granted once per
  // instance and card (host_launch.cuh).
  static int granted[host_launch::kMaxDevices] = {};
  const cudaError_t attr =
      host_launch::opt_in(flash_fwd_bf16_mma<D>, granted, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(b * heads, (sq + kMmaRows - 1) / kMmaRows);
  flash_fwd_bf16_mma<D><<<grid, kMmaThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      sq, skv, heads, kv_heads, causal, q_offset, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma_d(int d, const void* q, const void* k, const void* v, void* o,
                 float* lse, int b, int sq, int skv, int heads, int kv_heads, int causal,
                 int q_offset, int window, float softcap, float scale,
                 cudaStream_t stream) {
  switch (d) {
    case 16: return launch_mma<16>(q, k, v, o, lse, b, sq, skv, heads, kv_heads, causal, q_offset, window, softcap, scale, stream);
    case 32: return launch_mma<32>(q, k, v, o, lse, b, sq, skv, heads, kv_heads, causal, q_offset, window, softcap, scale, stream);
    case 64: return launch_mma<64>(q, k, v, o, lse, b, sq, skv, heads, kv_heads, causal, q_offset, window, softcap, scale, stream);
    case 128: return launch_mma<128>(q, k, v, o, lse, b, sq, skv, heads, kv_heads, causal, q_offset, window, softcap, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int mma_smem_bytes(int d) {
  switch (d) {
    case 16: return MmaTile<16>::kSmemBytes;
    case 32: return MmaTile<32>::kSmemBytes;
    case 64: return MmaTile<64>::kSmemBytes;
    case 128: return MmaTile<128>::kSmemBytes;
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  lse,
// when not null, receives each row's float32 log-sum-exp of its scaled
// (and capped) scores, (b, heads, sq), in natural-log units: what the
// backward kernels (flash_attention_bwd.cu) recompute P from.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int b, int sq, int skv, int heads,
                                      int kv_heads, int d,
                                      int dtype, int causal, int q_offset,
                                      int window, float softcap, float scale,
                                      int device, void* stream) {
  const host_launch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_d<float>(d, q, k, v, o, static_cast<float*>(lse), b, sq, skv,
                           heads, kv_heads, causal, q_offset, window, softcap,
                           scale, s);
  }
  if (dtype == 1) {
    return launch_mma_d(d, q, k, v, o, static_cast<float*>(lse), b, sq, skv,
                        heads, kv_heads, causal, q_offset, window, softcap,
                        scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of the bfloat16 kernel for head dim d (-1: none).
extern "C" int flash_attention_bf16_smem_bytes(int d) { return mma_smem_bytes(d); }

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
