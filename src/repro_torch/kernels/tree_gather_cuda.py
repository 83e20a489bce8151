"""CUDA tree-gather kernels: plan, build, bind, launch (counterpart of
the reference's ``repro.kernels.tree_gather_pallas``).

``csrc/tree_gather.cu`` holds two kernels for Hopper (sm_90a):

  * ``tree_gather_leaves`` — (rows, trees) float32 leaf values for
    standardized rows: the twin of the Pallas ``_tree_gather_kernel``.
  * ``tree_predict_fused`` — one clamped prediction per row from raw
    features: standardize on load, traverse, reduce over trees in a
    fixed order, ``max(bias + scale·red, 0)``.

Each runs one of two routes, which `plan` picks (pure arithmetic, so
the CPU tests hold it): ``staged`` (the bank's complete level-order
layout copied into shared memory) and ``packed`` (the packed node layout
of a bank too deep to keep complete, read through L1 and L2).  `plan`
also picks how many threads share a row, which sets the rows a block
holds and the grid, and whether consecutive threads take consecutive
rows or a row's tree groups.

The library is built at first use by `repro_torch.kernels._build`
(nvcc ``-shared`` into ``build/``, keyed by a hash of the sources and
flags) and loaded with ctypes.  Nothing is built or loaded at import time.

Every wrapper checks device, dtype, contiguity and shape, allocates the
output itself, launches on the operand's card (the C entry point takes
its index and makes it current, so a launch from any thread reaches the
card its tensors are on) and on torch's current stream of that card and
raises if the C entry point reports a CUDA error.  A wrapper adds one to
its entry in `LAUNCHES` where it launches its kernel, and nowhere else;
``route_counts()`` counts the same launches by route.  CPU tensors never
reach this module: `repro_torch.kernels.tree_gather` sends a host bank
to the plain torch versions and a CUDA bank here.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels._build import CudaLibrary, LaunchCounter
from repro_torch.kernels._build import check_tensor as _check

THREADS = 256                            # threads a block
# Threads that share a row (powers of two); a block holds THREADS / G rows.
GROUPS = (1, 2, 4, 8, 16, 32, 64, 128)
ROUTES = ("staged", "packed")
# Dynamic shared memory one block may opt into on sm_90 (227 KB), and
# what one SM holds for all its resident blocks (228 KB; the runtime
# keeps 1 KB per block).
SMEM_OPTIN_BYTES = 232448
SMEM_PER_SM_BYTES = 233472
MAX_BLOCKS_PER_SM = 8                    # 2048 threads / 256 per block
# A bank is kept complete (the ``staged`` route) when that layout takes
# at most this much shared memory: room for three blocks an SM.
COMPLETE_MAX_BYTES = 64 * 1024
# Threads a row by rows an SM: (at most this many rows an SM, threads a
# row), first match.  Few rows spread their trees over many threads; many
# rows give each thread more trees and each block more rows, so that a
# block stages the bank for more work.  Read from ``compare_kernels.py
# --sweep`` on an H100 SXM (150 trees of depth 4, 5 to 32,768 rows): each
# entry was the fastest or within 6% of it at every timed shape.
FUSED_GROUPS = ((8.0, 32), (20.0, 16), (48.0, 8), (160.0, 4), (float("inf"), 2))
LEAVES_GROUPS = ((1.0, 128), (8.0, 32), (20.0, 16), (100.0, 8), (float("inf"), 4))

# Launches per kernel and per route; `reset_launch_counts` zeroes both.
_COUNTER = LaunchCounter("tree_gather_leaves", "tree_predict_fused")
_ROUTE_COUNTER = LaunchCounter(*ROUTES, routes=True)
LAUNCHES: Dict[str, int] = _COUNTER.counts
launch_counts = _COUNTER.snapshot
route_counts = _ROUTE_COUNTER.snapshot


def reset_launch_counts() -> None:
    _COUNTER.reset()
    _ROUTE_COUNTER.reset()


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tree_gather_leaves_launch.argtypes = [
        i, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
    lib.tree_gather_leaves_launch.restype = i
    lib.tree_predict_fused_launch.argtypes = [
        i, p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, f, i, i, i, i, p]
    lib.tree_predict_fused_launch.restype = i


LIBRARY = CudaLibrary("tree_gather", ("tree_gather.cu",), _declare,
                      headers=("ptx_copy.cuh", "host_launch.cuh"))


# -- launch plan ----------------------------------------------------------------

def _align16(n: int) -> int:
    return -(-n // 16) * 16


def complete_bytes(n_trees: int, depth: int) -> int:
    """Shared-memory bytes of the complete layout (`tree_gather.complete_layout`):
    8-byte internal nodes, then 4-byte leaves, each section 16-byte aligned."""
    n_int = (1 << depth) - 1
    return _align16(n_trees * n_int * 8) + _align16(n_trees * (n_int + 1) * 4)


def has_complete(n_trees: int, depth: int) -> bool:
    """Whether a bank of ``n_trees`` trees of ``depth`` levels is kept in
    the complete layout (the ``staged`` route)."""
    return n_trees > 0 and complete_bytes(n_trees, depth) <= COMPLETE_MAX_BYTES


@dataclass(frozen=True)
class Plan:
    """One launch: ``route``, ``groups`` threads a row (``rows_per_block``
    = THREADS / groups rows a block, x staged at ``x_stride`` floats a
    row), ``rows_on_lanes`` (consecutive threads take consecutive rows;
    else a row's groups), ``smem_bytes`` of dynamic shared memory and a
    persistent ``grid``."""
    route: str
    groups: int
    rows_on_lanes: bool
    rows_per_block: int
    x_stride: int
    smem_bytes: int
    grid: int

    @property
    def log_groups(self) -> int:
        return self.groups.bit_length() - 1


def make_plan(route: str, groups: int, rows_on_lanes: bool, n_trees: int,
              depth: int, rows: int, d: int, n_sm: int) -> Plan:
    """The launch of ``route`` with ``groups`` threads a row, laid out by
    ``rows_on_lanes`` (`plan` passes its choice; ``compare_kernels.py
    --sweep`` every other).  Raises
    ValueError when the block's rows of x (and, staged, the bank) do not
    fit in the shared memory a block may take."""
    if route not in ROUTES or groups not in GROUPS:
        raise ValueError(f"no launch for route {route!r} with {groups} threads a row")
    rows_per_block = THREADS // groups
    x_stride = d | 1                     # odd: rows of x start on other banks
    smem = rows_per_block * x_stride * 4 + THREADS * 4     # x, partial sums
    if route == "staged":
        smem += complete_bytes(n_trees, depth)
    if smem > SMEM_OPTIN_BYTES:
        raise ValueError(f"{rows_per_block} rows of {d} features do not fit in "
                         f"shared memory on the {route} route "
                         f"({smem} B > {SMEM_OPTIN_BYTES} B)")
    per_sm = max(1, min(MAX_BLOCKS_PER_SM, SMEM_PER_SM_BYTES // (smem + 1024)))
    grid = max(1, min(-(-rows // rows_per_block), n_sm * per_sm))
    return Plan(route, groups, bool(rows_on_lanes), rows_per_block, x_stride,
                smem, grid)


@functools.lru_cache(maxsize=4096)
def plan(fused: bool, n_trees: int, depth: int, complete: bool, rows: int,
         d: int, n_sm: int) -> Plan:
    """The launch of the fused (``fused``) or leaves kernel for ``rows``
    rows of ``d`` features on a bank of ``n_trees`` trees of ``depth``
    levels (``complete``: the bank keeps the complete layout).

    Route: ``staged`` for a complete bank, else ``packed``.  Threads a
    row: `FUSED_GROUPS` / `LEAVES_GROUPS` at ``rows / n_sm``, at most the
    trees rounded up to a power of two.  The fused kernel puts rows on
    the lanes when fewer than 32 threads share a row (a warp's lanes then
    walk one tree for 32 rows: its node loads are broadcasts within one
    tree); the leaves kernel never does (a warp's stores then land on one
    row's consecutive trees).  Where a block's rows of x do not fit in
    shared memory, more threads a row (fewer rows a block) are taken;
    where they fit nowhere, ValueError.  Cached: the wrappers ask once
    per shape."""
    route = "staged" if complete else "packed"
    per_sm = rows / n_sm
    want = next(g for most, g in (FUSED_GROUPS if fused else LEAVES_GROUPS)
                if per_sm <= most)
    want = min(want, max(GROUPS[0], 1 << max(0, n_trees - 1).bit_length()))
    err = None
    for g in (g for g in GROUPS if g >= want):
        try:
            return make_plan(route, g, fused and g < 32, n_trees, depth, rows,
                             d, n_sm)
        except ValueError as e:
            err = e
    raise err


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """Streaming multiprocessors of card ``index``, asked once per card."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(bank, rows: int, d: int, fused: bool,
             whole_rows: Optional[int] = None) -> Plan:
    """`plan` for ``rows`` rows of ``d`` features on ``bank`` (a `CudaBank`
    on the card).  With ``whole_rows``, the rows are one shard of a
    sharded flush of that many: the launch keeps the whole flush's route,
    threads a row and lane layout (so each row's trees are summed in the
    order the unsharded flush sums them) with a grid for the shard."""
    index = bank.device.index
    n_sm = _sm_count(torch.cuda.current_device() if index is None else index)
    pl = plan(fused, bank.n_trees, bank.depth, bank.cnodes is not None,
              rows if whole_rows is None else whole_rows, d, n_sm)
    if whole_rows is None or whole_rows == rows:
        return pl
    return make_plan(pl.route, pl.groups, pl.rows_on_lanes, bank.n_trees,
                     bank.depth, rows, d, n_sm)


def _check_bank_and_x(bank, x: torch.Tensor) -> None:
    if bank.device.type != "cuda":
        raise ValueError("the CUDA kernels need a bank resident on the card")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got shape {tuple(x.shape)}")
    if x.shape[1] < bank.n_features:
        raise ValueError(f"x has {x.shape[1]} features; the bank splits on "
                         f"feature indices up to {bank.n_features - 1}")
    _check(x, "x", torch.float32, bank.device, tuple(x.shape))


def _bank_pointers(bank, route: str) -> tuple:
    """The C entry points' ``b0, b1, b2`` for ``route``."""
    if route == "packed":
        if bank.nodes is None:
            raise ValueError(f"the packed route needs a bank too deep for the "
                             f"complete layout ({bank.n_trees} trees of depth "
                             f"{bank.depth} are kept complete)")
        return bank.nodes.data_ptr(), bank.value.data_ptr(), bank.roots.data_ptr()
    if bank.cnodes is None:
        raise ValueError(f"the {route} route needs a bank kept in the complete "
                         f"layout ({bank.n_trees} trees of depth {bank.depth} are not)")
    return bank.cnodes.data_ptr(), bank.cleaves.data_ptr(), None


# -- wrappers -----------------------------------------------------------------

def gather_leaves_cuda(bank, x: torch.Tensor,
                       whole_rows: Optional[int] = None) -> torch.Tensor:
    """(rows, trees) float32 leaf values for standardized rows ``x``
    (float32, contiguous, on the bank's card) — `tree_gather_leaves`;
    ``whole_rows`` as in `plan_for`."""
    _check_bank_and_x(bank, x)
    rows, d = x.shape
    if rows == 0:
        return torch.empty((0, bank.n_trees), dtype=torch.float32,
                           device=bank.device)
    return launch_leaves(bank, x, plan_for(bank, rows, d, False, whole_rows))


def launch_leaves(bank, x: torch.Tensor, pl: Plan) -> torch.Tensor:
    """One `tree_gather_leaves` launch on checked operands with the plan
    ``pl`` (`gather_leaves_cuda` passes `plan`'s)."""
    rows, d = x.shape
    out = torch.empty((rows, bank.n_trees), dtype=torch.float32,
                      device=bank.device)
    b0, b1, b2 = _bank_pointers(bank, pl.route)
    lib = LIBRARY.load()
    err = lib.tree_gather_leaves_launch(
        ROUTES.index(pl.route), b0, b1, b2, x.data_ptr(), out.data_ptr(),
        rows, d, bank.n_trees, bank.depth, pl.log_groups, int(pl.rows_on_lanes),
        pl.x_stride, pl.grid, pl.smem_bytes, x.get_device(),
        torch.cuda.current_stream(x.device).cuda_stream)
    LIBRARY.raise_on(err, "tree_gather_leaves")
    _COUNTER.add("tree_gather_leaves")
    _ROUTE_COUNTER.add(pl.route)
    return out


def fused_predict_cuda(bank, mean: torch.Tensor, std: torch.Tensor,
                       scale: float, bias: float, x: torch.Tensor,
                       kind: str, whole_rows: Optional[int] = None) -> torch.Tensor:
    """(rows,) float32 clamped predictions from raw rows ``x`` —
    `tree_predict_fused`.  ``kind`` is "sum" (GBDT) or "mean" (RF);
    ``whole_rows`` as in `plan_for`."""
    if kind not in ("sum", "mean"):
        raise ValueError(f"unknown reduction {kind!r} (sum or mean)")
    _check_bank_and_x(bank, x)
    rows, d = x.shape
    _check(mean, "mean", torch.float32, bank.device, (d,))
    _check(std, "std", torch.float32, bank.device, (d,))
    if rows == 0:
        return torch.empty((0,), dtype=torch.float32, device=bank.device)
    return launch_fused(bank, mean, std, scale, bias, x, kind,
                        plan_for(bank, rows, d, True, whole_rows))


def launch_fused(bank, mean: torch.Tensor, std: torch.Tensor, scale: float,
                 bias: float, x: torch.Tensor, kind: str, pl: Plan) -> torch.Tensor:
    """One `tree_predict_fused` launch on checked operands with the plan
    ``pl`` (`fused_predict_cuda` passes `plan`'s)."""
    rows, d = x.shape
    out = torch.empty((rows,), dtype=torch.float32, device=bank.device)
    b0, b1, b2 = _bank_pointers(bank, pl.route)
    lib = LIBRARY.load()
    err = lib.tree_predict_fused_launch(
        ROUTES.index(pl.route), b0, b1, b2, x.data_ptr(), mean.data_ptr(),
        std.data_ptr(), out.data_ptr(), rows, d, bank.n_trees, bank.depth,
        pl.log_groups, int(pl.rows_on_lanes), pl.x_stride,
        float(np.float32(scale)), float(np.float32(bias)), int(kind == "mean"),
        pl.grid, pl.smem_bytes, x.get_device(),
        torch.cuda.current_stream(x.device).cuda_stream)
    LIBRARY.raise_on(err, "tree_predict_fused")
    _COUNTER.add("tree_predict_fused")
    _ROUTE_COUNTER.add(pl.route)
    return out


def predict_trees_cuda(flat, x: np.ndarray, device="cuda") -> np.ndarray:
    """(n_rows, n_trees) float64 leaf values via `tree_gather_leaves`
    on ``flat``'s bank resident on the card (uploaded once)."""
    db = flat.device_bank(device)
    if db.device.type != "cuda":
        raise ValueError("predict_trees_cuda needs a CUDA device")
    out = db.gather_leaves(db.stage_input(x))
    return out.cpu().numpy().astype(np.float64)
