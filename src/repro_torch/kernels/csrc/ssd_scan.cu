// Inter-chunk SSD recurrence (Mamba2) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssd_scan_kernel` in
// src/repro/kernels/ssd_scan.py:29 (entry `ssd_scan`).
//
//   h_prev[c] = h_{c-1}                   (h_{-1} = 0)
//   h_c       = decay[c] * h_{c-1} + s[c]
//   h_final   = h_{nc-1}
//
// s and h_prev are (NC, B, H, P, N) and h_final (B, H, P, N), contiguous, in
// s's type (float32 or bfloat16); decay is (NC, B, H) in float32 or
// bfloat16.  The state is carried in float32, as the Pallas kernel's VMEM
// scratch is, and rounded to s's type only where it is stored.  The update
// is __fadd_rn(__fmul_rn(state, dec), s): two rounded operations and never
// an FMA, so the kernel is bit-equal to its plain torch version, which
// computes `state * dec + s` as two rounded ops.
//
// What bounds it on this card.  Two operations per state element and chunk
// against at least 8 bytes (s read, h_prev written, 4 bytes each in
// float32): bound by bytes.  At Mamba2 2.7B's forward (NC 16, B 2, H 80,
// P 64, N 128, float32) it reads 83.9 MB and writes 83.9 MB + 5.2 MB, 51.6 us
// at 3.35 TB/s.
//
// Design.  The Pallas kernel folds (b, h) into rows and (p, n) into
// columns, transposes the operands to (BH, NC, PN) and walks a sequential
// chunk grid axis with the state resident in VMEM.  On Hopper none of that
// is needed: every one of the B*H*P*N state elements is independent, so
// one thread owns four neighbouring elements (one 16-byte float32 vector,
// or 8 bytes of bfloat16) and loops over the chunks with its state in
// registers.  Element (bh, j) of chunk c sits at c*BH*PN + bh*PN + j in the
// (NC, B, H, P, N) layout as it is, so neighbouring threads read and write
// neighbouring addresses without a transpose, and no state is shared
// between threads, so there is no shared memory and no barrier.  The loop
// takes two chunks a step, issuing both chunks' loads before either
// update, so each thread keeps two loads in flight.  Any NC >= 0, any B*H
// and any P*N: a P*N that is not a multiple of four, or an operand that is
// not aligned to its vector, takes the scalar kernel (one element a
// thread), and the last block masks its tail.
//
// Backward (`ssd_scan_bwd_launch`).  The reference has no Pallas backward:
// XLA differentiates the lax.scan of src/repro/models/ssm.py:105-114.  With
// upstream gradients g_prev (NC, B, H, P, N) for h_prev and g_final
// (B, H, P, N) for h_final (null: zero), the adjoint of h_c runs in
// reverse,
//
//   G_{NC-1} = g_final,   G_{c-1} = G_c * decay[c] + g_prev[c]  (c >= 1),
//   ds[c] = G_c,          ddecay[c] = sum_{p,n} G_c * h_prev[c],
//
// (G_{-1}, the zero initial state's gradient, feeds no output, so g_prev[0]
// and decay[0] are not read), with G carried in float32 and updated as __fadd_rn(__fmul_rn(G, dec), g)
// (two rounded operations, never an FMA), so ds is bit-equal to the plain
// version, which computes `G * dec + g` as two rounded ops.  g_prev, h_prev
// and ds are in s's type, decay and ddecay in decay's.
//
// What bounds it.  G's update and the products for ddecay are four
// operations per state element and chunk against 12 bytes (g_prev and
// h_prev read, ds written, float32): bound by bytes.  At Mamba2 2.7B's
// training call (NC 4, B 4, H 80, P 64, N 128, float32, no g_final) it
// moves (3 NC - 1) x 10.5 MB = 115 MB, 34.4 us at 3.35 TB/s.
//
// Design.  The forward's layout and rules: one thread owns four
// neighbouring elements of one (b, h) row (one element on the scalar
// route) and walks the chunks backwards with G in registers.  ddecay is a
// sum over the row's P*N elements (8,192 for Mamba2, 4,096 for Zamba2),
// taken in a fixed order and without float atomics, so it repeats bit for
// bit: the thread's own products in order, a warp's by xor shuffles, the
// block's eight warps in order through shared memory.  So a block covers
// one stretch of one row (grid x = the B*H rows, grid y = the stretches of
// a row); a row of one stretch writes ddecay from its block, a row of
// several writes one partial a block into a float32 scratch that a second
// kernel, one thread a (chunk, row), sums in block order.
//
// The kernels allocate nothing and launch on the caller's stream and card
// (host_launch.cuh's DeviceGuard); the C entry points return
// cudaGetLastError() of their launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "host_launch.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);          // round to nearest even
}

// Four consecutive elements: one 16-byte (float32) or 8-byte (bfloat16)
// access, widened to float32 on load and rounded once on store.
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec4<__nv_bfloat16> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* v) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
    v[0] = __low2float(a); v[1] = __high2float(a);
    v[2] = __low2float(b); v[3] = __high2float(b);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* v) {
    uint2 x;
    *reinterpret_cast<__nv_bfloat162*>(&x.x) =
        __halves2bfloat162(__float2bfloat16(v[0]), __float2bfloat16(v[1]));
    *reinterpret_cast<__nv_bfloat162*>(&x.y) =
        __halves2bfloat162(__float2bfloat16(v[2]), __float2bfloat16(v[3]));
    *reinterpret_cast<uint2*>(p) = x;
  }
};

__device__ __forceinline__ float step(float state, float dec, float s) {
  return __fadd_rn(__fmul_rn(state, dec), s);
}

// One thread per 4 consecutive state elements (P*N % 4 == 0, so the four
// share one (b, h) row and one decay).
template <typename T, typename D>
__global__ void __launch_bounds__(kThreads)
ssd_scan_vec4(const T* __restrict__ s, const D* __restrict__ decay,
              T* __restrict__ h_prev, T* __restrict__ h_final,
              int nc, long long bh, long long pn) {
  const long long vec = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long plane = bh * pn;             // elements of one chunk
  const long long e = 4 * vec;                 // first element of this thread
  if (e >= plane) return;
  const long long row = e / pn;                // (b, h) index
  float st[4] = {0.f, 0.f, 0.f, 0.f};
  int c = 0;
  for (; c + 1 < nc; c += 2) {
    const long long o0 = c * plane + e, o1 = o0 + plane;
    float s0[4], s1[4];
    Vec4<T>::load(s + o0, s0);
    Vec4<T>::load(s + o1, s1);
    const float d0 = to_f32(decay[c * bh + row]);
    const float d1 = to_f32(decay[(c + 1) * bh + row]);
    Vec4<T>::store(h_prev + o0, st);
#pragma unroll
    for (int i = 0; i < 4; ++i) st[i] = step(st[i], d0, s0[i]);
    Vec4<T>::store(h_prev + o1, st);
#pragma unroll
    for (int i = 0; i < 4; ++i) st[i] = step(st[i], d1, s1[i]);
  }
  if (c < nc) {
    const long long o0 = c * plane + e;
    float s0[4];
    Vec4<T>::load(s + o0, s0);
    const float d0 = to_f32(decay[c * bh + row]);
    Vec4<T>::store(h_prev + o0, st);
#pragma unroll
    for (int i = 0; i < 4; ++i) st[i] = step(st[i], d0, s0[i]);
  }
  Vec4<T>::store(h_final + e, st);
}

// One thread per state element: any P*N and any alignment.
template <typename T, typename D>
__global__ void __launch_bounds__(kThreads)
ssd_scan_scalar(const T* __restrict__ s, const D* __restrict__ decay,
                T* __restrict__ h_prev, T* __restrict__ h_final,
                int nc, long long bh, long long pn) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long plane = bh * pn;
  if (e >= plane) return;
  const long long row = e / pn;
  float st = 0.f;
  int c = 0;
  for (; c + 1 < nc; c += 2) {
    const long long o0 = c * plane + e, o1 = o0 + plane;
    const float s0 = to_f32(s[o0]), s1 = to_f32(s[o1]);
    const float d0 = to_f32(decay[c * bh + row]);
    const float d1 = to_f32(decay[(c + 1) * bh + row]);
    store(h_prev + o0, st);
    st = step(st, d0, s0);
    store(h_prev + o1, st);
    st = step(st, d1, s1);
  }
  if (c < nc) {
    const long long o0 = c * plane + e;
    const float s0 = to_f32(s[o0]);
    const float d0 = to_f32(decay[c * bh + row]);
    store(h_prev + o0, st);
    st = step(st, d0, s0);
  }
  store(h_final + e, st);
}

template <typename T>
bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

template <typename T, typename D>
int launch(const void* s, const void* decay, void* h_prev, void* h_final,
           int nc, long long bh, long long pn, cudaStream_t stream) {
  const long long plane = bh * pn;
  const bool vec = pn % 4 == 0 && aligned<T>(s) && aligned<T>(h_prev) &&
                   aligned<T>(h_final);
  const long long threads = vec ? plane / 4 : plane;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks == 0) return static_cast<int>(cudaSuccess);   // no state elements
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const T* sp = static_cast<const T*>(s);
  const D* dp = static_cast<const D*>(decay);
  T* hp = static_cast<T*>(h_prev);
  T* hf = static_cast<T*>(h_final);
  if (vec) {
    ssd_scan_vec4<T, D><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        sp, dp, hp, hf, nc, bh, pn);
  } else {
    ssd_scan_scalar<T, D><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        sp, dp, hp, hf, nc, bh, pn);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_decay(const void* s, const void* decay, void* h_prev, void* h_final,
                 int nc, long long bh, long long pn, int d_dtype,
                 cudaStream_t stream) {
  if (d_dtype == 0) {
    return launch<T, float>(s, decay, h_prev, h_final, nc, bh, pn, stream);
  }
  if (d_dtype == 1) {
    return launch<T, __nv_bfloat16>(s, decay, h_prev, h_final, nc, bh, pn, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// -- backward ------------------------------------------------------------------

constexpr int kWarps = kThreads / 32;

// V consecutive elements (V = 4: one vector; V = 1: one scalar) of one row,
// widened to float32 on load and rounded once on store.
template <typename T, int V>
struct Elems {
  __device__ __forceinline__ static void load(const T* p, float* v) {
    if constexpr (V == 4) {
      Vec4<T>::load(p, v);
    } else {
      v[0] = to_f32(*p);
    }
  }
  __device__ __forceinline__ static void store_(T* p, const float* v) {
    if constexpr (V == 4) {
      Vec4<T>::store(p, v);
    } else {
      store(p, v[0]);
    }
  }
};

// Block (row, stretch): elements stretch * kThreads * V + threadIdx.x * V
// .. + V - 1 of row `row`; threads past the row's end hold zeros and take
// part in the sums and barriers.
template <typename T, typename D, int V>
__global__ void __launch_bounds__(kThreads)
ssd_scan_bwd(const T* __restrict__ g_prev, const T* __restrict__ g_final,
             const T* __restrict__ h_prev, const D* __restrict__ decay,
             T* __restrict__ ds, float* __restrict__ partial,
             D* __restrict__ ddecay, int nc, long long bh, long long pn,
             int stretches) {
  __shared__ float warp_sums[kWarps];
  const long long row = blockIdx.x;
  const long long e = (static_cast<long long>(blockIdx.y) * kThreads + threadIdx.x) * V;
  const bool in = e < pn;
  const long long plane = bh * pn;
  const long long at = row * pn + e;            // offset within one chunk
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float G[V];
#pragma unroll
  for (int i = 0; i < V; ++i) G[i] = 0.f;
  if (in && g_final != nullptr) Elems<T, V>::load(g_final + at, G);
  for (int c = nc - 1; c >= 0; --c) {
    float part = 0.f;
    if (in) {
      const long long o = c * plane + at;
      float h[V];
      Elems<T, V>::load(h_prev + o, h);
      Elems<T, V>::store_(ds + o, G);
#pragma unroll
      for (int i = 0; i < V; ++i) part = __fadd_rn(part, __fmul_rn(G[i], h[i]));
      if (c > 0) {                               // G_{-1} feeds no output
        float g[V];
        Elems<T, V>::load(g_prev + o, g);
        const float dec = to_f32(decay[c * bh + row]);
#pragma unroll
        for (int i = 0; i < V; ++i) G[i] = step(G[i], dec, g[i]);
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, m));
    }
    if (lane == 0) warp_sums[warp] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = warp_sums[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum = __fadd_rn(sum, warp_sums[w]);
      const long long r = c * bh + row;
      if (stretches == 1) {
        store(ddecay + r, sum);
      } else {
        partial[r * stretches + blockIdx.y] = sum;
      }
    }
    __syncthreads();                             // warp_sums is reused
  }
}

// ddecay[r] = the stretches' partials of (chunk, row) r, summed in order.
template <typename D>
__global__ void __launch_bounds__(kThreads)
ssd_scan_bwd_rows(const float* __restrict__ partial, D* __restrict__ ddecay,
                  long long rows, int stretches) {
  const long long r = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= rows) return;
  const float* p = partial + r * stretches;
  float sum = p[0];
  for (int i = 1; i < stretches; ++i) sum = __fadd_rn(sum, p[i]);
  store(ddecay + r, sum);
}

template <typename T, typename D>
int launch_bwd(const void* g_prev, const void* g_final, const void* h_prev,
               const void* decay, void* ds, void* partial, void* ddecay, int nc,
               long long bh, long long pn, cudaStream_t stream) {
  const bool vec = pn % 4 == 0 && aligned<T>(g_prev) && aligned<T>(h_prev) &&
                   aligned<T>(ds) && (g_final == nullptr || aligned<T>(g_final));
  const long long per_block = static_cast<long long>(kThreads) * (vec ? 4 : 1);
  const long long stretches = (pn + per_block - 1) / per_block;
  if (nc == 0 || bh == 0 || pn == 0) return static_cast<int>(cudaSuccess);
  if (bh > 0x7fffffffLL || stretches > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(static_cast<unsigned>(bh), static_cast<unsigned>(stretches));
  const T* gp = static_cast<const T*>(g_prev);
  const T* gf = static_cast<const T*>(g_final);
  const T* hp = static_cast<const T*>(h_prev);
  const D* dp = static_cast<const D*>(decay);
  T* dsp = static_cast<T*>(ds);
  float* pp = static_cast<float*>(partial);
  D* ddp = static_cast<D*>(ddecay);
  const int n = static_cast<int>(stretches);
  if (vec) {
    ssd_scan_bwd<T, D, 4><<<grid, kThreads, 0, stream>>>(gp, gf, hp, dp, dsp, pp, ddp,
                                                         nc, bh, pn, n);
  } else {
    ssd_scan_bwd<T, D, 1><<<grid, kThreads, 0, stream>>>(gp, gf, hp, dp, dsp, pp, ddp,
                                                         nc, bh, pn, n);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 1) return static_cast<int>(err);
  const long long rows = static_cast<long long>(nc) * bh;
  const long long blocks = (rows + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  ssd_scan_bwd_rows<D><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      pp, ddp, rows, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_decay(const void* g_prev, const void* g_final, const void* h_prev,
                     const void* decay, void* ds, void* partial, void* ddecay,
                     int nc, long long bh, long long pn, int d_dtype,
                     cudaStream_t stream) {
  if (d_dtype == 0) {
    return launch_bwd<T, float>(g_prev, g_final, h_prev, decay, ds, partial, ddecay,
                                nc, bh, pn, stream);
  }
  if (d_dtype == 1) {
    return launch_bwd<T, __nv_bfloat16>(g_prev, g_final, h_prev, decay, ds, partial,
                                        ddecay, nc, bh, pn, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// s_dtype, d_dtype: 0 = float32, 1 = bfloat16.  bh = B*H, pn = P*N.
extern "C" int ssd_scan_launch(const void* s, const void* decay, void* h_prev,
                               void* h_final, int nc, long long bh, long long pn,
                               int s_dtype, int d_dtype, int device,
                               void* stream) {
  const host_launch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nc < 0 || bh < 0 || pn < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (s_dtype == 0) {
    return launch_decay<float>(s, decay, h_prev, h_final, nc, bh, pn, d_dtype, st);
  }
  if (s_dtype == 1) {
    return launch_decay<__nv_bfloat16>(s, decay, h_prev, h_final, nc, bh, pn,
                                       d_dtype, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward: g_prev, h_prev and ds (NC, B, H, P, N) and g_final
// (B, H, P, N; null for zero) in s's type, decay and ddecay (NC, B, H) in
// decay's (g_prev[0] and decay[0] are not read: they would only feed the
// gradient of the zero initial state); partial is a float32 scratch of at least NC * B * H *
// ceil(P*N / 256) floats (the most stretches a row can take).
extern "C" int ssd_scan_bwd_launch(const void* g_prev, const void* g_final,
                                   const void* h_prev, const void* decay, void* ds,
                                   void* partial, void* ddecay, int nc, long long bh,
                                   long long pn, int s_dtype, int d_dtype, int device,
                                   void* stream) {
  const host_launch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nc < 0 || bh < 0 || pn < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (s_dtype == 0) {
    return launch_bwd_decay<float>(g_prev, g_final, h_prev, decay, ds, partial,
                                   ddecay, nc, bh, pn, d_dtype, st);
  }
  if (s_dtype == 1) {
    return launch_bwd_decay<__nv_bfloat16>(g_prev, g_final, h_prev, decay, ds,
                                           partial, ddecay, nc, bh, pn, d_dtype, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
