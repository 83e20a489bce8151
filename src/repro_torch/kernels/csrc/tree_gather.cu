// Tree-ensemble traversal on Hopper (sm_90a): two kernels, two routes.
//
// Replaces the Pallas TPU kernel `_tree_gather_kernel` in
// src/repro/kernels/tree_gather_pallas.py (and, for the fused kernel, the
// jnp standardize / reduce / clamp around it in the pallas branch of
// `fused_predict`, src/repro/kernels/tree_gather.py).
//
//   tree_gather_leaves : out[row, t] = leaf of tree t for x[row]      (rows, trees) f32
//   tree_predict_fused : out[row]    = max(bias + scale * reduce_t leaf_t(xs[row]), 0)
//                        with xs = (x - mean) / std applied on load;
//                        reduce = sum (GBDT) or sum / trees (RF).
//
// Every walk runs exactly `depth` rounds of "go left when x[feature] <=
// threshold" from the tree's root.
//
// What bounds it on this card.  Each input is read once and each output
// written once: x (rows * d * 4 bytes), the output, and the bank.  The
// arithmetic is a few integer and float operations per slot (row x tree)
// and round, far below the card's rate, so the ideal kernel is bound by
// bytes, and on the main path that bound is below the floor of one
// launch (about 1.9 us back to back on an H100 SXM).  What a launch pays
// is latency (staging the bank, then `depth` dependent lookups per slot)
// and, at thousands of rows, the shared-memory loads of the walk itself.
//
// Design.
//  * Bank layouts.  A bank of shallow trees (the GBDT's depth <= 4) is
//    kept as complete level-order trees: tree t's internal node i is an
//    int2 {feature, threshold bits} at t * (2^depth - 1) + i, its leaves
//    2^depth floats at t * 2^depth.  The child of i is 2i + 1 + !(x <= thr),
//    so a round is one 8-byte load and no child pointer.  A leaf of the
//    original tree above the last level was repeated into both children
//    when the layout was built, so every route ends on the same value
//    (ties and NaN features included) and the leaves stay bit-equal.
//    150 trees of depth 4 take 27.6 KB instead of 88 KB of packed nodes.
//    A bank too deep for that (a depth-14 forest) keeps the packed layout:
//    int4 {feature, threshold bits, left, right} per node, a float value,
//    and self-looping leaves.
//  * Routes.  `staged`: the complete layout is copied into shared memory
//    with 16-byte cp.async from every thread, all in flight at once and
//    overlapped with the first row block's load of x, one wait.
//    `packed`: the packed layout, read through L1 and L2.
//  * Mapping.  `groups` (G, a power of two) threads share a row; thread
//    g walks trees g, g + G, g + 2G, ... four at a time, so four
//    independent chains of lookups are in flight.  A block of 256
//    threads holds 256 / G rows.  With `rows_on_lanes`, consecutive
//    threads take consecutive rows, so the lanes of a warp walk one tree
//    for 32 rows and its node loads are broadcasts within that tree;
//    otherwise they take a row's G groups (a warp's leaf stores then land
//    on one row's consecutive trees).  The launch plan picks G and the
//    layout from the rows an SM.  Rows of x are staged in shared memory
//    (standardized on load in the fused kernel) with an odd stride.  The
//    grid is persistent: a block walks row blocks grid-stride and stages
//    the bank once.
//  * Determinism.  A thread adds its trees in increasing order; the G
//    partial sums of a row are added in a fixed order (an xor-shuffle
//    tree within a warp, then warp partials in warp order; or, rows on
//    lanes, the groups in group order through shared memory): no
//    atomics, so a launch is bit-repeatable.  The order depends on the
//    plan, so the fused result is held to the float32 summation bound,
//    not to bits.
//  * Routing bit-equal with the reference.  The compare is `xv <= thr`
//    in float32, and the standardization is an IEEE subtraction and
//    division (__fsub_rn / __fdiv_rn: no reciprocal-multiply, no FMA
//    contraction; build without --use_fast_math).  The leaves then match
//    the plain version and the reference's jax and Pallas tiers exactly.
//
// The kernels allocate nothing and launch on the caller's stream and
// card (host_launch.cuh's DeviceGuard); each C
// entry point returns cudaGetLastError() of its launch, or the error of the
// shared-memory opt-in that refused it.

#include <cuda_runtime.h>

#include "ptx_copy.cuh"
#include "host_launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 4;            // trees a thread walks at once
enum Route { kStaged = 0, kPacked = 1 };

struct Args {
  // complete layout: b0 = internal nodes (int2), b1 = leaves (float);
  // packed layout:   b0 = nodes (int4), b1 = value (float), b2 = roots.
  const void* b0;
  const void* b1;
  const int* b2;
  const float* x;
  const float* mean;
  const float* stdv;
  float* out;
  int rows, d, n_trees, depth;
  int groups, log_groups;        // G threads a row, G = 1 << log_groups
  int rows_per_block, log_rows;  // kThreads / G rows a block
  int rows_on_lanes;             // consecutive threads take consecutive rows
  int x_stride;
  float scale, bias;
  int mean_reduce;
};

__device__ __forceinline__ int align16(int bytes) { return (bytes + 15) & ~15; }

// Walks trees t, t + G, ..., t + (kN - 1) G for one row (staged x at
// `xrow`), writing each tree's leaf value into leaf[].  The rounds are the
// outer loop so the kN lookups of a round are independent.
template <int kRoute, int kN>
__device__ __forceinline__ void walk(const Args& a, const void* b0,
                                     const void* b1, const float* xrow,
                                     int t, float (&leaf)[kN]) {
  if (kRoute == kPacked) {
    const int4* nodes = static_cast<const int4*>(b0);
    const float* value = static_cast<const float*>(b1);
    int nid[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) nid[k] = __ldg(a.b2 + t + k * a.groups);
    for (int r = 0; r < a.depth; ++r) {
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        const int4 nd = __ldg(nodes + nid[k]);
        nid[k] = (xrow[nd.x] <= __int_as_float(nd.y)) ? nd.z : nd.w;
      }
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) leaf[k] = __ldg(value + nid[k]);
  } else {
    const int2* nodes = static_cast<const int2*>(b0);
    const float* leaves = static_cast<const float*>(b1);
    const int n_int = (1 << a.depth) - 1;
    int base[kN], i[kN];             // tree k's first node; its level-order index
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      base[k] = (t + k * a.groups) * n_int;
      i[k] = 0;
    }
    for (int r = 0; r < a.depth; ++r) {
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        const int2 nd = nodes[base[k] + i[k]];
        i[k] = 2 * i[k] + ((xrow[nd.x] <= __int_as_float(nd.y)) ? 1 : 2);
      }
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      // leaves of tree t' start at t' * 2^depth = base + t'; leaf i - n_int.
      leaf[k] = leaves[base[k] + (t + k * a.groups) + (i[k] - n_int)];
    }
  }
}

// Walks kN trees from t and folds their leaves in: added to acc in tree
// order (fused) or written to the row's outputs `orow`.
template <bool kFused, int kRoute, int kN>
__device__ __forceinline__ void walk_and_fold(const Args& a, const void* b0,
                                              const void* b1, const float* xrow,
                                              int t, long long orow, float& acc) {
  float leaf[kN];
  walk<kRoute, kN>(a, b0, b1, xrow, t, leaf);
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    if (kFused) {
      acc = __fadd_rn(acc, leaf[k]);
    } else {
      a.out[orow + t + k * a.groups] = leaf[k];
    }
  }
}

template <bool kFused, int kRoute>
__global__ void __launch_bounds__(kThreads) tree_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const void* b0 = a.b0;
  const void* b1 = a.b1;
  float* xs = reinterpret_cast<float*>(smem);
  if (kRoute == kStaged) {
    // The whole complete bank, 16 bytes a copy, every copy in flight.
    const int n_int = (1 << a.depth) - 1;
    const int node_bytes = a.n_trees * n_int * 8;
    const int leaf_bytes = a.n_trees * (n_int + 1) * 4;
    unsigned char* s_leaves = smem + align16(node_bytes);
    const char* g_nodes = static_cast<const char*>(a.b0);
    const char* g_leaves = static_cast<const char*>(a.b1);
    for (int off = threadIdx.x * 16; off < node_bytes; off += kThreads * 16) {
      ptx::cp_async_16(smem + off, g_nodes + off, min(16, node_bytes - off));
    }
    for (int off = threadIdx.x * 16; off < leaf_bytes; off += kThreads * 16) {
      ptx::cp_async_16(s_leaves + off, g_leaves + off, min(16, leaf_bytes - off));
    }
    ptx::cp_async_commit();
    b0 = smem;
    b1 = s_leaves;
    xs = reinterpret_cast<float*>(s_leaves + align16(leaf_bytes));
  }
  float* partial = xs + a.rows_per_block * a.x_stride;   // kThreads floats

  const int G = a.groups;
  const int tid = threadIdx.x;
  const int r = a.rows_on_lanes ? (tid & (a.rows_per_block - 1)) : (tid >> a.log_groups);
  const int g = a.rows_on_lanes ? (tid >> a.log_rows) : (tid & (G - 1));
  const int n_row_blocks = (a.rows + a.rows_per_block - 1) / a.rows_per_block;
  for (int rb = blockIdx.x; rb < n_row_blocks; rb += gridDim.x) {
    const int row0 = rb * a.rows_per_block;
    const int nr = min(a.rows_per_block, a.rows - row0);
    __syncthreads();                 // the previous row block's readers are done
    const float* xsrc = a.x + static_cast<long long>(row0) * a.d;
    for (int e = tid; e < nr * a.d; e += kThreads) {
      const int rr = e / a.d;
      const int j = e - rr * a.d;
      float v = __ldg(xsrc + e);
      if (kFused) v = __fdiv_rn(__fsub_rn(v, __ldg(a.mean + j)), __ldg(a.stdv + j));
      xs[rr * a.x_stride + j] = v;
    }
    if (kRoute == kStaged) ptx::cp_async_wait<0>();
    __syncthreads();

    // Trees g, g + G, ... in increasing order, kInFlight at a time.
    float acc = 0.f;
    if (r < nr) {
      const float* xrow = xs + r * a.x_stride;
      const long long orow = static_cast<long long>(row0 + r) * a.n_trees;
      int t = g;
      for (; t + (kInFlight - 1) * G < a.n_trees; t += kInFlight * G) {
        walk_and_fold<kFused, kRoute, kInFlight>(a, b0, b1, xrow, t, orow, acc);
      }
      for (; t < a.n_trees; t += G) {
        walk_and_fold<kFused, kRoute, 1>(a, b0, b1, xrow, t, orow, acc);
      }
    }
    if (kFused) {
      // The G partial sums of a row, added in a fixed order.
      if (a.rows_on_lanes) {
        if (G > 1) {
          partial[tid] = acc;
          __syncthreads();
          if (g == 0) {
            for (int h = 1; h < G; ++h) {
              acc = __fadd_rn(acc, partial[(h << a.log_rows) + r]);
            }
          }
        }
      } else {
        const int span = G < 32 ? G : 32;
        for (int off = span >> 1; off > 0; off >>= 1) {
          acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
        }
        if (G > 32) {
          if ((tid & 31) == 0) partial[tid >> 5] = acc;
          __syncthreads();
          if (g == 0) {
            const float* p = partial + (tid >> 5);
            for (int w = 1; w < (G >> 5); ++w) acc = __fadd_rn(acc, p[w]);
          }
        }
      }
      if (g == 0 && r < nr) {
        const float red =
            a.mean_reduce ? __fdiv_rn(acc, static_cast<float>(a.n_trees)) : acc;
        const float v = __fadd_rn(a.bias, __fmul_rn(a.scale, red));
        a.out[row0 + r] = (v < 0.f) ? 0.f : v;
      }
    }
  }
}

template <bool kFused, int kRoute>
cudaError_t launch(const Args& a, int grid, int smem_bytes, void* stream) {
  static int granted[host_launch::kMaxDevices] = {};
  const cudaError_t err =
      host_launch::opt_in(tree_kernel<kFused, kRoute>, granted, smem_bytes);
  if (err != cudaSuccess) return err;
  tree_kernel<kFused, kRoute><<<grid, kThreads, smem_bytes,
                                static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

template <bool kFused>
int dispatch(int route, const Args& a, int grid, int smem_bytes, void* stream) {
  switch (route) {
    case kStaged: return static_cast<int>(launch<kFused, kStaged>(a, grid, smem_bytes, stream));
    case kPacked: return static_cast<int>(launch<kFused, kPacked>(a, grid, smem_bytes, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Args make_args(const void* b0, const void* b1, const void* b2, const void* x,
               int rows, int d, int n_trees, int depth, int log_groups,
               int rows_on_lanes, int x_stride) {
  Args a{};
  a.b0 = b0;
  a.b1 = b1;
  a.b2 = static_cast<const int*>(b2);
  a.x = static_cast<const float*>(x);
  a.rows = rows;
  a.d = d;
  a.n_trees = n_trees;
  a.depth = depth;
  a.log_groups = log_groups;
  a.groups = 1 << log_groups;
  a.rows_per_block = kThreads >> log_groups;
  a.log_rows = __builtin_ctz(static_cast<unsigned>(a.rows_per_block));
  a.rows_on_lanes = rows_on_lanes;
  a.x_stride = x_stride;
  return a;
}

}  // namespace

// route: 0 staged, 1 packed; b0, b1, b2 as in `Args`.  A block of 256
// threads holds 256 >> log_groups rows.
extern "C" int tree_gather_leaves_launch(
    int route, const void* b0, const void* b1, const void* b2, const void* x,
    void* out, int rows, int d, int n_trees, int depth, int log_groups,
    int rows_on_lanes, int x_stride, int grid, int smem_bytes, int device,
    void* stream) {
  const host_launch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  Args a = make_args(b0, b1, b2, x, rows, d, n_trees, depth, log_groups,
                     rows_on_lanes, x_stride);
  a.out = static_cast<float*>(out);
  return dispatch<false>(route, a, grid, smem_bytes, stream);
}

extern "C" int tree_predict_fused_launch(
    int route, const void* b0, const void* b1, const void* b2, const void* x,
    const void* mean, const void* stdv, void* out, int rows, int d,
    int n_trees, int depth, int log_groups, int rows_on_lanes, int x_stride,
    float scale, float bias, int mean_reduce, int grid, int smem_bytes,
    int device, void* stream) {
  const host_launch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  Args a = make_args(b0, b1, b2, x, rows, d, n_trees, depth, log_groups,
                     rows_on_lanes, x_stride);
  a.mean = static_cast<const float*>(mean);
  a.stdv = static_cast<const float*>(stdv);
  a.out = static_cast<float*>(out);
  a.scale = scale;
  a.bias = bias;
  a.mean_reduce = mean_reduce;
  return dispatch<true>(route, a, grid, smem_bytes, stream);
}

extern "C" const char* tree_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
