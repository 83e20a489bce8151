// Intra-chunk SSD output of Mamba2 and its backward on Hopper (sm_90a), in
// float32 on the CUDA cores.
//
// Replaces no TPU kernel: the reference computes this part of the chunked SSD
// with einsums that XLA fuses (src/repro/models/ssm.py:90-101, `ssd_forward`),
// and XLA differentiates them.  The port's plain version is
// `ssd_intra_plain` in kernels/ssd_intra.py.  For one (batch, chunk) row bc
// and head h, with t and s the chunk's positions (0 <= t, s < Q),
//
//   w[t,s] = (exp(cum[t] - cum[s]) * cb[t,s]) * dt[s]     (s <= t)
//   w[t,s] = (exp(-60) * cb[t,s]) * dt[s]                  (s > t, masked)
//   y[t,:] = sum_s w[t,s] * x[s,:]
//
// x and y are (BC, Q, H, P), dt and cum (BC, Q, H), cb = C.B^T (BC, Q, Q),
// all float32 and contiguous.  cb is shared by the heads: the state size N
// never reaches the kernels.  The masked value -60 is set before the exp, as
// in the plain version (MASKED_DECAY), so above the diagonal nothing
// overflows.
//
// What bounds it on this card.  Per (bc, h) the causal half of the product is
// Q(Q+1)/2 * P multiply-adds forward, twice that backward (dx and dw), and
// each weight costs an exp.  At Mamba2 2.7B's training call (BC 16, Q 256,
// H 80, P 64) that is 5.4 GFLOP forward and 10.8 GFLOP backward, 80 us and
// 161 us at 67 TFLOP/s, against 84 MB for x, y, dy or dx each: 25 us a
// tensor at 3.35 TB/s.  Operations bound it.  The plain version writes the
// (BC, H, Q, Q) weights, 335 MB there, several times a call.
//
// Design.  No weight tile ever leaves the block.  Tiles are 64 x 64 (t x s);
// a tile strictly above the diagonal (every s > t) is skipped: its weights
// are exp(-60) ~ 8.8e-27 times cb * dt, below what a float32 sum of the kept
// terms (each at least that of the diagonal, exp(0) * cb * dt) can hold.
// Diagonal tiles keep their masked half, as the plain version does.
// Rows and columns past Q (a chunk shorter than a tile, or a sequence shorter
// than a chunk) are zero in shared memory and their weights are set to 0,
// never computed, so no inf or NaN reaches a sum.
//
//   ssd_intra_fwd     block (t-tile, h, bc), 256 threads: for each s-tile up
//                     to the diagonal, stage x's 64 rows of head h and build
//                     the 64 x 64 weights in shared memory, then each thread
//                     adds a 4 x 4 block of y (4 rows t, 4 columns p).
//   ssd_intra_bwd_dx  block (s-tile, h, bc): dx[s,:] = sum_t w[t,s] dy[t,:],
//                     the t-tiles from the diagonal down, the same way.
//   ssd_intra_bwd_dw  block (tile pair t >= s, head group, bc), looping over
//                     the group's heads: dw = dy x^T for the tile, then per
//                     element u = dw * dt[s], d cb += u * e (summed over the
//                     group's heads in registers), d pre = (u * cb) * e on the
//                     kept half (the gradient of cum[t] - cum[s]) and
//                     dw * (e * cb) (the gradient of dt[s]).  The tile's row
//                     sums of d pre and column sums of both go to per-tile
//                     partial arrays, in a fixed order: shuffles over the 16
//                     threads of a row, then the 16 rows of a column through
//                     shared memory in order.
//   ssd_intra_bwd_rows, ssd_intra_bwd_cb
//                     fixed-order sums of those partials: d dt[s] over the
//                     t-tiles, d cum[t] = (row sums over the s-tiles) minus
//                     (column sums over the t-tiles), d cb over the head
//                     groups (zero above the diagonal tiles).
//
// There are no floating-point atomics, so the backward repeats bit for bit.
// Shared memory rows hold 68 floats (64 + 4): 16-byte aligned for float4
// reads, and eight consecutive rows start in eight different bank groups, so
// a quarter warp reading one float4 from each of eight rows takes one pass.
// exp is expf (no fast-math intrinsics); the products are FMAs in float32:
// no TF32, no bfloat16.
//
// The kernels allocate nothing and launch on the caller's stream and card
// (host_launch.cuh's DeviceGuard); the C entry points return
// cudaGetLastError() of their launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "host_launch.cuh"

namespace {

constexpr int kTile = 64;            // t and s rows of a tile
constexpr int kThreads = 256;        // 16 x 16 threads, 4 x 4 results each
constexpr int kRow = kTile + 4;      // shared-memory row stride (floats)
constexpr float kMaskedDecay = -60.f;

struct Shape {
  long long bc;                      // batch x chunks
  int q, h;                          // chunk length, heads
};

// 64 rows of one head of a (BC, Q, H, P) tensor, rows r0.. of row bc, into
// dst[64][P + 4]; rows past Q are zero.
template <int P>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           const Shape& sh, long long bc, int h,
                                           int r0) {
  constexpr int kVecs = P / 4;                       // float4s a row
  constexpr int kRowsPerPass = kThreads / kVecs;
  const int v = threadIdx.x % kVecs;
#pragma unroll
  for (int r = threadIdx.x / kVecs; r < kTile; r += kRowsPerPass) {
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < sh.q) {
      const long long row = (bc * sh.q + r0 + r) * sh.h + h;
      val = *reinterpret_cast<const float4*>(src + row * P + 4 * v);
    }
    *reinterpret_cast<float4*>(dst + r * (P + 4) + 4 * v) = val;
  }
}

// cum and dt of head h at positions r0 .. r0 + 63 (zero past Q).
__device__ __forceinline__ void stage_column(float* dst, const float* __restrict__ src,
                                             const Shape& sh, long long bc, int h,
                                             int r0, int lane) {
  dst[lane] = r0 + lane < sh.q ? src[(bc * sh.q + r0 + lane) * sh.h + h] : 0.f;
}

// The weights of tile (t0, s0) of head h into w[64][kRow], row t, column s:
// one element a thread per pass, neighbouring threads on neighbouring s.
__device__ __forceinline__ void build_weights(float* w, const float* __restrict__ cb,
                                              const float* cum_t, const float* cum_s,
                                              const float* dt_s, const Shape& sh,
                                              long long bc, int t0, int s0) {
  const bool diagonal = t0 == s0;
  const float* cb_tile = cb + (bc * sh.q + t0) * sh.q + s0;
#pragma unroll 4
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int t = e / kTile, s = e % kTile;
    float val = 0.f;
    if (t0 + t < sh.q && s0 + s < sh.q) {
      const float d = diagonal && s > t ? kMaskedDecay : cum_t[t] - cum_s[s];
      val = __fmul_rn(__fmul_rn(expf(d), cb_tile[t * sh.q + s]), dt_s[s]);
    }
    w[t * kRow + s] = val;
  }
}

// y[t,:] = sum_{s <= t's tile} w[t,s] x[s,:] for one t-tile of one head.
template <int P>
__global__ void __launch_bounds__(kThreads)
ssd_intra_fwd(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ cum, const float* __restrict__ cb,
              float* __restrict__ y, Shape sh) {
  static_assert(P == 64, "one thread holds 4 of the 64 columns of a row");
  __shared__ __align__(16) float w[kTile * kRow];
  __shared__ __align__(16) float xs[kTile * (P + 4)];
  __shared__ float cum_t[kTile], cum_s[kTile], dt_s[kTile];
  const int ti = blockIdx.x, h = blockIdx.y;
  const long long bc = blockIdx.z;
  const int t0 = ti * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  if (threadIdx.x < kTile) stage_column(cum_t, cum, sh, bc, h, t0, threadIdx.x);
  float acc[4][4] = {};
  for (int si = 0; si <= ti; ++si) {
    const int s0 = si * kTile;
    __syncthreads();                                 // w, xs of the last tile read
    stage_rows<P>(xs, x, sh, bc, h, s0);
    if (threadIdx.x < kTile) {
      stage_column(cum_s, cum, sh, bc, h, s0, threadIdx.x);
      stage_column(dt_s, dt, sh, bc, h, s0, threadIdx.x);
    }
    __syncthreads();
    build_weights(w, cb, cum_t, cum_s, dt_s, sh, bc, t0, s0);
    __syncthreads();
#pragma unroll 2
    for (int s = 0; s < kTile; s += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = *reinterpret_cast<const float4*>(w + (ty + 16 * r) * kRow + s);
        b[r] = *reinterpret_cast<const float4*>(xs + (s + r) * (P + 4) + 4 * tx);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float av[4] = {a[r].x, a[r].y, a[r].z, a[r].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[r][0] = fmaf(av[k], b[k].x, acc[r][0]);
          acc[r][1] = fmaf(av[k], b[k].y, acc[r][1]);
          acc[r][2] = fmaf(av[k], b[k].z, acc[r][2]);
          acc[r][3] = fmaf(av[k], b[k].w, acc[r][3]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = t0 + ty + 16 * r;
    if (t < sh.q) {
      const long long row = (bc * sh.q + t) * sh.h + h;
      *reinterpret_cast<float4*>(y + row * P + 4 * tx) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
}

// dx[s,:] = sum_{t's tile >= s's tile} w[t,s] dy[t,:] for one s-tile of one
// head; each thread holds rows s = 4 ty .. 4 ty + 3.
template <int P>
__global__ void __launch_bounds__(kThreads)
ssd_intra_bwd_dx(const float* __restrict__ dy, const float* __restrict__ dt,
                 const float* __restrict__ cum, const float* __restrict__ cb,
                 float* __restrict__ dx, Shape sh) {
  static_assert(P == 64, "one thread holds 4 of the 64 columns of a row");
  __shared__ __align__(16) float w[kTile * kRow];
  __shared__ __align__(16) float gs[kTile * (P + 4)];
  __shared__ float cum_t[kTile], cum_s[kTile], dt_s[kTile];
  const int si = blockIdx.x, h = blockIdx.y;
  const long long bc = blockIdx.z;
  const int s0 = si * kTile;
  const int tiles = (sh.q + kTile - 1) / kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  if (threadIdx.x < kTile) {
    stage_column(cum_s, cum, sh, bc, h, s0, threadIdx.x);
    stage_column(dt_s, dt, sh, bc, h, s0, threadIdx.x);
  }
  float acc[4][4] = {};
  for (int ti = si; ti < tiles; ++ti) {
    const int t0 = ti * kTile;
    __syncthreads();
    stage_rows<P>(gs, dy, sh, bc, h, t0);
    if (threadIdx.x < kTile) stage_column(cum_t, cum, sh, bc, h, t0, threadIdx.x);
    __syncthreads();
    build_weights(w, cb, cum_t, cum_s, dt_s, sh, bc, t0, s0);
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < kTile; ++t) {
      const float4 a = *reinterpret_cast<const float4*>(w + t * kRow + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(gs + t * (P + 4) + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] = fmaf(av[r], b.x, acc[r][0]);
        acc[r][1] = fmaf(av[r], b.y, acc[r][1]);
        acc[r][2] = fmaf(av[r], b.z, acc[r][2]);
        acc[r][3] = fmaf(av[r], b.w, acc[r][3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int s = s0 + 4 * ty + r;
    if (s < sh.q) {
      const long long row = (bc * sh.q + s) * sh.h + h;
      *reinterpret_cast<float4*>(dx + row * P + 4 * tx) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
}

// Tile pair (ti >= si) of one head group.  Thread (ty, tx) holds rows
// t = ty + 16 r and columns s = tx + 16 c (r, c < 4).  Partial sums:
//   rowpart[bc][si][h][t]  = sum_{s in tile si} d pre[t,s]
//   colcum[bc][ti][h][s]   = sum_{t in tile ti} d pre[t,s]
//   colddt[bc][ti][h][s]   = sum_{t in tile ti} dw[t,s] * (e * cb)[t,s]
//   cbpart[bc][g][t][s]    = sum_{h in group g} dw[t,s] * dt[s] * e[t,s]
template <int P>
__global__ void __launch_bounds__(kThreads)
ssd_intra_bwd_dw(const float* __restrict__ dy, const float* __restrict__ x,
                 const float* __restrict__ dt, const float* __restrict__ cum,
                 const float* __restrict__ cb, float* __restrict__ rowpart,
                 float* __restrict__ colcum, float* __restrict__ colddt,
                 float* __restrict__ cbpart, Shape sh, int heads_per_group) {
  static_assert(P % 4 == 0, "rows are read as float4");
  __shared__ __align__(16) float gs[kTile * (P + 4)];
  __shared__ __align__(16) float xs[kTile * (P + 4)];
  __shared__ float cum_t[kTile], cum_s[kTile], dt_s[kTile];
  __shared__ float red_cum[16 * kTile], red_ddt[16 * kTile];
  // blockIdx.x enumerates the pairs (ti, si <= ti) row by row.
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= static_cast<int>(blockIdx.x)) ++ti;
  const int si = blockIdx.x - ti * (ti + 1) / 2;
  const int g = blockIdx.y;
  const long long bc = blockIdx.z;
  const int t0 = ti * kTile, s0 = si * kTile;
  const int tiles = (sh.q + kTile - 1) / kTile;
  const bool diagonal = ti == si;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int lane = threadIdx.x % 32;

  bool valid[4][4];
  float cbv[4][4], dcb[4][4] = {};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int t = t0 + ty + 16 * r, s = s0 + tx + 16 * c;
      valid[r][c] = t < sh.q && s < sh.q;
      cbv[r][c] = valid[r][c] ? cb[(bc * sh.q + t) * sh.q + s] : 0.f;
    }
  }
  const int h_end = min(sh.h, (g + 1) * heads_per_group);
  for (int h = g * heads_per_group; h < h_end; ++h) {
    __syncthreads();                                 // gs, xs, red_* read
    stage_rows<P>(gs, dy, sh, bc, h, t0);
    stage_rows<P>(xs, x, sh, bc, h, s0);
    if (threadIdx.x < kTile) {
      stage_column(cum_t, cum, sh, bc, h, t0, threadIdx.x);
      stage_column(cum_s, cum, sh, bc, h, s0, threadIdx.x);
      stage_column(dt_s, dt, sh, bc, h, s0, threadIdx.x);
    }
    __syncthreads();
    float dw[4][4] = {};
#pragma unroll 2
    for (int p = 0; p < P; p += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = *reinterpret_cast<const float4*>(gs + (ty + 16 * r) * (P + 4) + p);
        b[r] = *reinterpret_cast<const float4*>(xs + (tx + 16 * r) * (P + 4) + p);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          dw[r][c] = fmaf(a[r].x, b[c].x, dw[r][c]);
          dw[r][c] = fmaf(a[r].y, b[c].y, dw[r][c]);
          dw[r][c] = fmaf(a[r].z, b[c].z, dw[r][c]);
          dw[r][c] = fmaf(a[r].w, b[c].w, dw[r][c]);
        }
      }
    }
    float row_sum[4] = {}, col_cum[4] = {}, col_ddt[4] = {};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int s = tx + 16 * c;
        if (!valid[r][c]) continue;
        const bool masked = diagonal && s > t;
        const float e = expf(masked ? kMaskedDecay : cum_t[t] - cum_s[s]);
        const float u = __fmul_rn(dw[r][c], dt_s[s]);
        dcb[r][c] = __fadd_rn(dcb[r][c], __fmul_rn(u, e));
        const float ddt = __fmul_rn(dw[r][c], __fmul_rn(e, cbv[r][c]));
        const float dpre = masked ? 0.f : __fmul_rn(__fmul_rn(u, cbv[r][c]), e);
        row_sum[r] = __fadd_rn(row_sum[r], dpre);
        col_cum[c] = __fadd_rn(col_cum[c], dpre);
        col_ddt[c] = __fadd_rn(col_ddt[c], ddt);
      }
    }
    // Row sums over the 16 threads of a row (lanes 0-15 or 16-31 of a warp).
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int m = 8; m > 0; m >>= 1) {
        row_sum[r] = __fadd_rn(row_sum[r], __shfl_xor_sync(0xffffffffu, row_sum[r], m));
      }
    }
    if ((lane & 15) == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = t0 + ty + 16 * r;
        if (t < sh.q) rowpart[((bc * tiles + si) * sh.h + h) * sh.q + t] = row_sum[r];
      }
    }
    // Column sums over the 16 row groups, in order, through shared memory.
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      red_cum[ty * kTile + tx + 16 * c] = col_cum[c];
      red_ddt[ty * kTile + tx + 16 * c] = col_ddt[c];
    }
    __syncthreads();
    if (threadIdx.x < 2 * kTile) {
      const int s = threadIdx.x % kTile;
      const float* red = threadIdx.x < kTile ? red_cum : red_ddt;
      float sum = red[s];
#pragma unroll
      for (int k = 1; k < 16; ++k) sum = __fadd_rn(sum, red[k * kTile + s]);
      if (s0 + s < sh.q) {
        float* out = threadIdx.x < kTile ? colcum : colddt;
        out[((bc * tiles + ti) * sh.h + h) * sh.q + s0 + s] = sum;
      }
    }
  }
  const int groups = gridDim.y;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int t = t0 + ty + 16 * r, s = s0 + tx + 16 * c;
      if (valid[r][c]) cbpart[((bc * groups + g) * sh.q + t) * sh.q + s] = dcb[r][c];
    }
  }
}

// d dt and d cum at (bc, q, h), from the tile partials in tile order.
__global__ void __launch_bounds__(kThreads)
ssd_intra_bwd_rows(const float* __restrict__ rowpart, const float* __restrict__ colcum,
                   const float* __restrict__ colddt, float* __restrict__ ddt,
                   float* __restrict__ dcum, Shape sh) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= sh.bc * sh.q * sh.h) return;
  const int h = static_cast<int>(i % sh.h);
  const int q = static_cast<int>((i / sh.h) % sh.q);
  const long long bc = i / (static_cast<long long>(sh.h) * sh.q);
  const int tiles = (sh.q + kTile - 1) / kTile;
  const int own = q / kTile;
  auto at = [&](int tile) { return ((bc * tiles + tile) * sh.h + h) * sh.q + q; };
  float rows = rowpart[at(0)];
  for (int j = 1; j <= own; ++j) rows = __fadd_rn(rows, rowpart[at(j)]);
  float cols = colcum[at(own)], dts = colddt[at(own)];
  for (int k = own + 1; k < tiles; ++k) {
    cols = __fadd_rn(cols, colcum[at(k)]);
    dts = __fadd_rn(dts, colddt[at(k)]);
  }
  dcum[i] = __fsub_rn(rows, cols);
  ddt[i] = dts;
}

// d cb[bc, t, s]: the head groups' partials in order; zero above the
// diagonal tiles (their weights were skipped).
__global__ void __launch_bounds__(kThreads)
ssd_intra_bwd_cb(const float* __restrict__ cbpart, float* __restrict__ dcb, Shape sh,
                 int groups) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long plane = static_cast<long long>(sh.q) * sh.q;
  if (i >= sh.bc * plane) return;
  const long long bc = i / plane;
  const long long ts = i % plane;
  const int t = static_cast<int>(ts / sh.q), s = static_cast<int>(ts % sh.q);
  float sum = 0.f;
  if (s / kTile <= t / kTile) {
    sum = cbpart[bc * groups * plane + ts];
    for (int k = 1; k < groups; ++k) sum = __fadd_rn(sum, cbpart[(bc * groups + k) * plane + ts]);
  }
  dcb[i] = sum;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int blocks_of(long long n, unsigned* out) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  *out = static_cast<unsigned>(blocks);
  return 0;
}

}  // namespace

// Forward.  x, y (BC, Q, H, P), dt, cum (BC, Q, H), cb (BC, Q, Q), float32,
// contiguous, x and y 16-byte aligned; P must be 64.
extern "C" int ssd_intra_launch(const void* x, const void* dt, const void* cum,
                                const void* cb, void* y, long long bc, int q, int h,
                                int p, int device, void* stream) {
  const host_launch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (p != 64 || bc < 0 || q < 0 || h < 0 || !aligned16(x) || !aligned16(y)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bc == 0 || q == 0 || h == 0) return static_cast<int>(cudaSuccess);
  if (bc > 65535 || h > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Shape sh{bc, q, h};
  const dim3 grid((q + kTile - 1) / kTile, h, static_cast<unsigned>(bc));
  ssd_intra_fwd<64><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cum), static_cast<const float*>(cb),
      static_cast<float*>(y), sh);
  return static_cast<int>(cudaGetLastError());
}

// Backward.  dy, x, dx as x; dt, cum, ddt, dcum (BC, Q, H); cb, dcb
// (BC, Q, Q).  Scratch, float32: rowpart, colcum and colddt of BC * T * H * Q
// floats (T = ceil(Q / 64) tiles), cbpart of BC * groups * Q * Q, the heads
// split into `groups` runs of heads_per_group.  Four kernels, in order on
// the stream.
extern "C" int ssd_intra_bwd_launch(const void* dy, const void* x, const void* dt,
                                    const void* cum, const void* cb, void* dx,
                                    void* ddt, void* dcum, void* dcb, void* rowpart,
                                    void* colcum, void* colddt, void* cbpart,
                                    long long bc, int q, int h, int p,
                                    int heads_per_group, int device, void* stream) {
  const host_launch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (p != 64 || bc < 0 || q < 0 || h < 0 || heads_per_group < 1 ||
      !aligned16(dy) || !aligned16(x) || !aligned16(dx)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bc == 0 || q == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const int groups = (h + heads_per_group - 1) / heads_per_group;
  if (bc > 65535 || h > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Shape sh{bc, q, h};
  const int tiles = (q + kTile - 1) / kTile;
  const float* dyp = static_cast<const float*>(dy);
  const float* xp = static_cast<const float*>(x);
  const float* dtp = static_cast<const float*>(dt);
  const float* cump = static_cast<const float*>(cum);
  const float* cbp = static_cast<const float*>(cb);
  float* rp = static_cast<float*>(rowpart);
  float* cc = static_cast<float*>(colcum);
  float* cd = static_cast<float*>(colddt);
  float* cbpp = static_cast<float*>(cbpart);

  ssd_intra_bwd_dx<64><<<dim3(tiles, h, static_cast<unsigned>(bc)), kThreads, 0, st>>>(
      dyp, dtp, cump, cbp, static_cast<float*>(dx), sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 pairs(tiles * (tiles + 1) / 2, groups, static_cast<unsigned>(bc));
  ssd_intra_bwd_dw<64><<<pairs, kThreads, 0, st>>>(dyp, xp, dtp, cump, cbp, rp, cc, cd,
                                                   cbpp, sh, heads_per_group);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned blocks = 0;
  int bad = blocks_of(bc * q * h, &blocks);
  if (bad) return bad;
  ssd_intra_bwd_rows<<<blocks, kThreads, 0, st>>>(rp, cc, cd, static_cast<float*>(ddt),
                                                  static_cast<float*>(dcum), sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bad = blocks_of(bc * q * static_cast<long long>(q), &blocks);
  if (bad) return bad;
  ssd_intra_bwd_cb<<<blocks, kThreads, 0, st>>>(cbpp, static_cast<float*>(dcb), sh,
                                                groups);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ssd_intra_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
