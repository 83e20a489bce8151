// Tree-ensemble traversal on Hopper (sm_90a): two kernels.
//
// Replaces the Pallas TPU kernel `_tree_gather_kernel` in
// src/repro/kernels/tree_gather_pallas.py (and, for the fused kernel, the
// jnp standardize / reduce / clamp around it in the pallas branch of
// `fused_predict`, src/repro/kernels/tree_gather.py).
//
//   tree_gather_leaves : out[row, t] = value[walk_t(x[row])]        (rows, trees) f32
//   tree_predict_fused : out[row]    = max(bias + scale * reduce_t value[walk_t(xs[row])], 0)
//                        with xs = (x - mean) / std applied on load;
//                        reduce = sum (GBDT) or sum / trees (RF).
//
// walk_t runs exactly `depth` rounds of
//     nid <- x[row, feature[nid]] <= threshold[nid] ? left[nid] : right[nid]
// from the tree's root.  Leaves self-loop, so no round needs a mask.
//
// What bounds it on this card.  Each input is read once and each output
// written once: the bytes of x (rows * d * 4) plus the bytes written
// (rows * trees * 4, or rows * 4 fused), plus the bank (20 B a node).  The
// arithmetic is a handful of integer and float operations per slot and
// round, far below the card's rate, so the ideal kernel is bound by bytes.
// The traversal itself is a chain of dependent gathers, one per round, so
// in practice each slot is latency-bound: the design keeps every gather
// on-chip and runs many independent slots per SM to hide that latency.
//
// Design.
//  * Bank placement.  Nodes are packed as int4 {feature, threshold bits,
//    left, right} (one 16-byte load per round) plus a float value array.
//    When bank + row block fit in the 227 KB a block may opt into, the
//    block stages the bank in dynamic shared memory once and keeps it for
//    every row block it processes (persistent grid, grid-stride over row
//    blocks), so the per-round gathers hit shared memory.  Larger banks
//    (a depth-14 forest) stay in global memory; after first touch they
//    sit in L1 and the 50 MB L2.
//  * Row block.  ROWS_PER_BLOCK rows of x are copied to shared memory with
//    coalesced loads (standardized on load in the fused kernel), so the
//    data-dependent x[row, feature] gathers are shared-memory reads.
//  * Mapping.  One warp per row, lanes over trees (lane l walks trees
//    l, l+32, ...).  The leaves kernel writes consecutive trees from
//    consecutive lanes (coalesced).  The fused kernel accumulates each
//    lane's trees in a fixed order and finishes with a xor-shuffle tree:
//    no atomics, so a run is bit-repeatable.
//  * Routing bit-equal with the reference.  The compare is `xv <= thr`
//    in float32, and the standardization is an IEEE subtraction and
//    division (__fsub_rn / __fdiv_rn: no reciprocal-multiply, no FMA
//    contraction; build without --use_fast_math).  The leaves then match
//    the plain version and the reference's jax and Pallas tiers exactly.
//
// The kernels allocate nothing and launch on the caller's stream; each C
// entry point returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int walk(const int4* nodes, const float* xrow,
                                    int nid, int depth) {
  for (int r = 0; r < depth; ++r) {
    const int4 nd = nodes[nid];
    const float xv = xrow[nd.x];
    nid = (xv <= __int_as_float(nd.y)) ? nd.z : nd.w;
  }
  return nid;
}

// Shared body of both kernels.  kFused selects standardize-on-load and
// the in-warp reduction; otherwise every leaf is written out.
template <bool kFused>
__device__ __forceinline__ void traverse_body(
    const int4* __restrict__ g_nodes, const float* __restrict__ g_value,
    const int* __restrict__ roots, const float* __restrict__ x,
    const float* __restrict__ mean, const float* __restrict__ stdv,
    float* __restrict__ out, int rows, int d, int n_nodes, int n_trees,
    int depth, int rows_per_block, int bank_in_smem, float scale, float bias,
    int mean_reduce) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int4* nodes = g_nodes;
  const float* value = g_value;
  float* xs;
  if (bank_in_smem) {
    int4* s_nodes = reinterpret_cast<int4*>(smem);
    float* s_value = reinterpret_cast<float*>(s_nodes + n_nodes);
    for (int i = threadIdx.x; i < n_nodes; i += blockDim.x) {
      s_nodes[i] = __ldg(g_nodes + i);
      s_value[i] = __ldg(g_value + i);
    }
    nodes = s_nodes;
    value = s_value;
    xs = s_value + n_nodes;
  } else {
    xs = reinterpret_cast<float*>(smem);
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_row_blocks = (rows + rows_per_block - 1) / rows_per_block;
  for (int rb = blockIdx.x; rb < n_row_blocks; rb += gridDim.x) {
    const int row0 = rb * rows_per_block;
    const int nr = min(rows_per_block, rows - row0);
    // The bank is staged and the previous row block's readers are done.
    __syncthreads();
    const float* xsrc = x + static_cast<long long>(row0) * d;
    for (int i = threadIdx.x; i < nr * d; i += blockDim.x) {
      float v = __ldg(xsrc + i);
      if (kFused) {
        const int j = i % d;
        v = __fdiv_rn(__fsub_rn(v, __ldg(mean + j)), __ldg(stdv + j));
      }
      xs[i] = v;
    }
    __syncthreads();
    for (int r = warp; r < nr; r += kWarps) {
      const float* xrow = xs + r * d;
      float acc = 0.f;
      for (int t = lane; t < n_trees; t += 32) {
        const float leaf = value[walk(nodes, xrow, __ldg(roots + t), depth)];
        if (kFused) {
          acc = __fadd_rn(acc, leaf);
        } else {
          out[static_cast<long long>(row0 + r) * n_trees + t] = leaf;
        }
      }
      if (kFused) {
        for (int off = 16; off > 0; off >>= 1) {
          acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
        }
        if (lane == 0) {
          const float red =
              mean_reduce ? __fdiv_rn(acc, static_cast<float>(n_trees)) : acc;
          const float v = __fadd_rn(bias, __fmul_rn(scale, red));
          out[row0 + r] = (v < 0.f) ? 0.f : v;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) tree_gather_leaves(
    const int4* __restrict__ nodes, const float* __restrict__ value,
    const int* __restrict__ roots, const float* __restrict__ x,
    float* __restrict__ out, int rows, int d, int n_nodes, int n_trees,
    int depth, int rows_per_block, int bank_in_smem) {
  traverse_body<false>(nodes, value, roots, x, nullptr, nullptr, out, rows, d,
                       n_nodes, n_trees, depth, rows_per_block, bank_in_smem,
                       1.f, 0.f, 0);
}

__global__ void __launch_bounds__(kThreads) tree_predict_fused(
    const int4* __restrict__ nodes, const float* __restrict__ value,
    const int* __restrict__ roots, const float* __restrict__ x,
    const float* __restrict__ mean, const float* __restrict__ stdv,
    float* __restrict__ out, int rows, int d, int n_nodes, int n_trees,
    int depth, int rows_per_block, int bank_in_smem, float scale, float bias,
    int mean_reduce) {
  traverse_body<true>(nodes, value, roots, x, mean, stdv, out, rows, d,
                      n_nodes, n_trees, depth, rows_per_block, bank_in_smem,
                      scale, bias, mean_reduce);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem_bytes) {
  if (smem_bytes > 48 * 1024) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem_bytes));
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int tree_gather_leaves_launch(
    const void* nodes, const void* value, const void* roots, const void* x,
    void* out, int rows, int d, int n_nodes, int n_trees, int depth,
    int rows_per_block, int bank_in_smem, int grid, size_t smem_bytes,
    void* stream) {
  cudaError_t err = prepare(tree_gather_leaves, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  tree_gather_leaves<<<grid, kThreads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(nodes), static_cast<const float*>(value),
      static_cast<const int*>(roots), static_cast<const float*>(x),
      static_cast<float*>(out), rows, d, n_nodes, n_trees, depth,
      rows_per_block, bank_in_smem);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tree_predict_fused_launch(
    const void* nodes, const void* value, const void* roots, const void* x,
    const void* mean, const void* stdv, void* out, int rows, int d,
    int n_nodes, int n_trees, int depth, int rows_per_block, int bank_in_smem,
    float scale, float bias, int mean_reduce, int grid, size_t smem_bytes,
    void* stream) {
  cudaError_t err = prepare(tree_predict_fused, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  tree_predict_fused<<<grid, kThreads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(nodes), static_cast<const float*>(value),
      static_cast<const int*>(roots), static_cast<const float*>(x),
      static_cast<const float*>(mean), static_cast<const float*>(stdv),
      static_cast<float*>(out), rows, d, n_nodes, n_trees, depth,
      rows_per_block, bank_in_smem, scale, bias, mean_reduce);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tree_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
