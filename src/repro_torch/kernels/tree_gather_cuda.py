"""CUDA tree-gather kernels: build, bind, launch (counterpart of the
reference's ``repro.kernels.tree_gather_pallas``).

``csrc/tree_gather.cu`` holds two kernels for Hopper (sm_90a):

  * ``tree_gather_leaves`` — (rows, trees) float32 leaf values for
    standardized rows: the twin of the Pallas ``_tree_gather_kernel``.
  * ``tree_predict_fused`` — one clamped prediction per row from raw
    features: standardize on load, traverse, reduce over trees in a
    fixed order, ``max(bias + scale·red, 0)``.

The library is built at first use by `repro_torch.kernels._build`
(nvcc ``-shared`` into ``build/``, keyed by a hash of the sources and
flags) and loaded with ctypes.  Nothing is built or loaded at import time.

Every wrapper checks device, dtype, contiguity and shape, allocates the
output itself, launches on torch's current stream and raises if the C
entry point reports a CUDA error.  A wrapper adds one to its entry in
`LAUNCHES` where it launches its kernel, and nowhere else.  CPU tensors
never reach this module: `repro_torch.kernels.tree_gather` sends a host
bank to the plain torch versions and a CUDA bank here.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels._build import CudaLibrary, LaunchCounter
from repro_torch.kernels._build import check_tensor as _check

# Rows of x staged in shared memory per block iteration (8 warps, one
# row per warp at a time: 4 rows per warp per block iteration).
ROWS_PER_BLOCK = 32
# Dynamic shared memory one block may opt into on sm_90 (227 KB), and
# what one SM holds for all its resident blocks (228 KB; the runtime
# keeps 1 KB per block).
SMEM_OPTIN_BYTES = 232448
SMEM_PER_SM_BYTES = 233472
MAX_BLOCKS_PER_SM = 8                    # 2048 threads / 256 per block
BANK_BYTES_PER_NODE = 20                 # int4 node + float value

# Launches per kernel; `reset_launch_counts` zeroes them.
_COUNTER = LaunchCounter("tree_gather_leaves", "tree_predict_fused")
LAUNCHES: Dict[str, int] = _COUNTER.counts
launch_counts = _COUNTER.snapshot
reset_launch_counts = _COUNTER.reset


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f, z = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_size_t
    lib.tree_gather_leaves_launch.argtypes = [
        p, p, p, p, p, i, i, i, i, i, i, i, i, z, p]
    lib.tree_gather_leaves_launch.restype = i
    lib.tree_predict_fused_launch.argtypes = [
        p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, f, i, i, z, p]
    lib.tree_predict_fused_launch.restype = i


LIBRARY = CudaLibrary("tree_gather", ("tree_gather.cu",), _declare)


# -- launch geometry ----------------------------------------------------------

def launch_plan(n_nodes: int, rows: int, d: int, n_sm: int) -> Dict[str, int]:
    """Shared-memory bytes, bank placement and grid for one launch.

    The bank goes to shared memory when it fits beside one row block;
    otherwise it stays in global memory (read through L2) and only the
    row block is staged.  The grid is persistent: at most as many blocks
    as can be resident at once on ``n_sm`` SMs, each looping over row
    blocks, so a block stages the bank once however many rows it scores.
    """
    x_bytes = ROWS_PER_BLOCK * d * 4
    if x_bytes > SMEM_OPTIN_BYTES:
        raise ValueError(f"{d} features per row do not fit one row block "
                         f"in shared memory ({x_bytes} B > {SMEM_OPTIN_BYTES} B)")
    bank_bytes = n_nodes * BANK_BYTES_PER_NODE
    in_smem = bank_bytes + x_bytes <= SMEM_OPTIN_BYTES
    smem = (bank_bytes if in_smem else 0) + x_bytes
    per_sm = max(1, min(MAX_BLOCKS_PER_SM, SMEM_PER_SM_BYTES // (smem + 1024)))
    row_blocks = -(-rows // ROWS_PER_BLOCK)
    return {"bank_in_smem": int(in_smem), "smem_bytes": smem,
            "grid": max(1, min(row_blocks, n_sm * per_sm))}


def _plan(bank, rows: int, d: int) -> Dict[str, int]:
    n_sm = torch.cuda.get_device_properties(bank.device).multi_processor_count
    return launch_plan(bank.n_nodes, rows, d, n_sm)


def _check_bank_and_x(bank, x: torch.Tensor) -> None:
    if bank.device.type != "cuda":
        raise ValueError("the CUDA kernels need a bank resident on the card")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got shape {tuple(x.shape)}")
    if x.shape[1] < bank.n_features:
        raise ValueError(f"x has {x.shape[1]} features; the bank splits on "
                         f"feature indices up to {bank.n_features - 1}")
    _check(x, "x", torch.float32, bank.device, tuple(x.shape))
    _check(bank.nodes, "bank.nodes", torch.int32, bank.device,
           (bank.n_nodes, 4))
    _check(bank.value, "bank.value", torch.float32, bank.device,
           (bank.n_nodes,))
    _check(bank.roots, "bank.roots", torch.int32, bank.device,
           (bank.n_trees,))


# -- wrappers -----------------------------------------------------------------

def gather_leaves_cuda(bank, x: torch.Tensor) -> torch.Tensor:
    """(rows, trees) float32 leaf values for standardized rows ``x``
    (float32, contiguous, on the bank's card) — `tree_gather_leaves`."""
    _check_bank_and_x(bank, x)
    rows, d = x.shape
    out = torch.empty((rows, bank.n_trees), dtype=torch.float32,
                      device=bank.device)
    if rows == 0:
        return out
    lib = LIBRARY.load()
    plan = _plan(bank, rows, d)
    stream = torch.cuda.current_stream(bank.device).cuda_stream
    err = lib.tree_gather_leaves_launch(
        bank.nodes.data_ptr(), bank.value.data_ptr(), bank.roots.data_ptr(),
        x.data_ptr(), out.data_ptr(), rows, d, bank.n_nodes, bank.n_trees,
        bank.depth, ROWS_PER_BLOCK, plan["bank_in_smem"], plan["grid"],
        plan["smem_bytes"], stream)
    LIBRARY.raise_on(err, "tree_gather_leaves")
    _COUNTER.add("tree_gather_leaves")
    return out


def fused_predict_cuda(bank, mean: torch.Tensor, std: torch.Tensor,
                       scale: float, bias: float, x: torch.Tensor,
                       kind: str) -> torch.Tensor:
    """(rows,) float32 clamped predictions from raw rows ``x`` —
    `tree_predict_fused`.  ``kind`` is "sum" (GBDT) or "mean" (RF)."""
    if kind not in ("sum", "mean"):
        raise ValueError(f"unknown reduction {kind!r} (sum or mean)")
    _check_bank_and_x(bank, x)
    rows, d = x.shape
    _check(mean, "mean", torch.float32, bank.device, (d,))
    _check(std, "std", torch.float32, bank.device, (d,))
    out = torch.empty((rows,), dtype=torch.float32, device=bank.device)
    if rows == 0:
        return out
    lib = LIBRARY.load()
    plan = _plan(bank, rows, d)
    stream = torch.cuda.current_stream(bank.device).cuda_stream
    err = lib.tree_predict_fused_launch(
        bank.nodes.data_ptr(), bank.value.data_ptr(), bank.roots.data_ptr(),
        x.data_ptr(), mean.data_ptr(), std.data_ptr(), out.data_ptr(),
        rows, d, bank.n_nodes, bank.n_trees, bank.depth, ROWS_PER_BLOCK,
        plan["bank_in_smem"], float(np.float32(scale)),
        float(np.float32(bias)), int(kind == "mean"), plan["grid"],
        plan["smem_bytes"], stream)
    LIBRARY.raise_on(err, "tree_predict_fused")
    _COUNTER.add("tree_predict_fused")
    return out


def predict_trees_cuda(flat, x: np.ndarray, device="cuda") -> np.ndarray:
    """(n_rows, n_trees) float64 leaf values via `tree_gather_leaves`
    on ``flat``'s bank resident on the card (uploaded once)."""
    db = flat.device_bank(device)
    if db.device.type != "cuda":
        raise ValueError("predict_trees_cuda needs a CUDA device")
    out = gather_leaves_cuda(db, db.stage_input(x))
    return out.cpu().numpy().astype(np.float64)
