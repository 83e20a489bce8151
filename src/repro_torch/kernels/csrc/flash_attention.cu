// Flash attention (online softmax, grouped K/V heads) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention.py (entry `flash_attention`).
//
//   o[b, i, h, :] = sum_j softmax_j(s_ij) * v[b, j, h / rep, :],
//   s_ij = (q[b, i, h, :] . k[b, j, h / rep, :]) * scale,  rep = H / KVH,
//
// with s_ij = -1e30 where causal masking hides key j from query i
// (j > i + q_offset) and for keys past the sequence.  q is (b, sq, H, D),
// k and v (b, skv, KVH, D), o (b, sq, H, D), all contiguous and all float32
// or all bfloat16.  Query head h reads kv head h / rep, so grouped-query
// attention needs no repeated K/V; the TPU kernel's equal-heads case is
// rep = 1.  Scores, the running max, the denominator and the accumulator
// are float32 (the Pallas kernel's VMEM scratch becomes registers), the
// denominator is clamped at 1e-30 as in its `_finalize`, and the output
// is rounded once to the input type.
//
// What bounds it on this card.  The work is 4*b*H*sq*skv*D operations
// (halved by causal masking) against (2*b*sq*H + 2*b*skv*KVH)*D elements
// moved, so at the serving path's shapes (s = 1024, D = 64) it is bound by
// operations: about 8.6 GFLOP a launch at b = 4, H = 16, 8.7 us at the
// tensor cores' 989 TFLOP/s.  This first kernel runs on the CUDA cores in
// float32 (67 TFLOP/s peak), so its own floor is some 15x higher, and it
// stays well above that: besides its 2*D multiply-adds a score costs every
// lane of its row a shared-memory read per 4 values, the shuffles and an
// expf, and ~170 registers a thread leave room for 3 blocks an SM.
//
// Design.
//  * One block of 128 threads per (b*H, tile of query rows).  A query row
//    belongs to D/16 consecutive lanes, each holding 16 of its D values of
//    q and of the accumulator in registers; a dot product is summed over
//    those lanes with xor shuffles, which give every lane the same sum.
//  * K and V tiles of BKV keys are staged through shared memory as
//    float32, read from device memory in 16-byte loads (q, k and v must be
//    16-byte aligned; rows are, as D is a multiple of 16); the scores of
//    one tile stay in registers while the running max, the denominator and
//    the accumulator are rescaled once per tile.
//  * Causal: key tiles wholly above the block's last query are never
//    loaded (the `pl.when` skip of flash_attention.py:46-48); inside the
//    diagonal tile keys are masked per row.
//  * Any sq and skv: rows past sq compute and are not stored, keys past skv
//    are zero-filled and masked (the Pallas kernel asserts divisibility).
//  * expf, fmaf and IEEE division: no fast-math intrinsics.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry point returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSeg = 16;              // head dims per lane
constexpr float kNegInf = -1.0e30f;   // the Pallas kernel's NEG_INF

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);           // round to nearest even
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
    T* __restrict__ o, int sq, int skv, int heads, int kv_heads, int causal,
    int q_offset, float scale) {
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
  const T* kb = k + static_cast<long long>(bi) * skv * kv_row +
                static_cast<long long>(kvi) * D;
  const T* vb = v + static_cast<long long>(bi) * skv * kv_row +
                static_cast<long long>(kvi) * D;

  for (int t0 = 0; t0 < kv_end; t0 += BKV) {
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
      const bool seen = key < skv && (!causal || key <= qpos);
      s[j] = seen ? dot * scale : kNegInf;
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
  T* op = o + (static_cast<long long>(bi) * sq + qi) * q_row +
          static_cast<long long>(hi) * D + seg;
#pragma unroll
  for (int c = 0; c < kSeg; ++c) store(op + c, acc[c] / denom);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int skv, int heads, int kv_heads, int causal, int q_offset,
           float scale, cudaStream_t stream) {
  const dim3 grid((sq + Tile<D>::kRows - 1) / Tile<D>::kRows, b * heads);
  flash_fwd<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, heads, kv_heads,
      causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             int b, int sq, int skv, int heads, int kv_heads, int causal,
             int q_offset, float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, b, sq, skv, heads, kv_heads, causal, q_offset, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, b, sq, skv, heads, kv_heads, causal, q_offset, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, sq, skv, heads, kv_heads, causal, q_offset, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, sq, skv, heads, kv_heads, causal, q_offset, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int sq,
                                      int skv, int heads, int kv_heads, int d,
                                      int dtype, int causal, int q_offset,
                                      float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_d<float>(d, q, k, v, o, b, sq, skv, heads, kv_heads, causal,
                           q_offset, scale, s);
  }
  if (dtype == 1) {
    return launch_d<__nv_bfloat16>(d, q, k, v, o, b, sq, skv, heads, kv_heads,
                                   causal, q_offset, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
