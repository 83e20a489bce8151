"""CUDA int8 GEMM: plan, build, bind, launch (``csrc/int8_matmul.cu``).

``int8_matmul_cuda(a_q, bt, scale, bias)`` → (m, n) float32
``f32(a_q · btᵀ + bias) · scale`` on the card, where ``bt`` is the weight
prepacked by `repro_torch.kernels.int8_matmul.pack_weight` and ``a_q`` is
(m, k) int8 with unit column stride and any row stride ≥ k (the
executor's im2col rows are padded to 16 bytes, so they take the
kernel's ``cp.async`` route).

`plan` picks the block tile and the split of k for a shape (pure
Python, so the CPU tests hold it).  Every call is one device launch; a
split of k runs as thread-block clusters that reduce in their own shared
memory, so it needs no workspace.

The wrapper checks device, dtype, strides and shape, allocates the
output, launches on the operand's card (the C entry point takes its
index and makes it current, so a launch from any thread reaches the card
its tensors are on) and on torch's current stream of that card and
raises if the C entry point reports a CUDA error.  It adds one to
``LAUNCHES["int8_matmul"]`` where it launches the kernel, and nowhere
else; ``route_counts()`` counts the same launches twice, once by k route
(``one_pass`` or ``split_k``) and once by how A reaches shared memory
(``a_cp_async`` or ``a_words``).  CPU tensors never reach this module.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels._build import CudaLibrary, LaunchCounter
from repro_torch.kernels._build import check_tensor as _check

SMS = 132                            # streaming multiprocessors of an H100 SXM
K_STEP = 32                          # k bytes of one mma step; splits are multiples
MAX_SPLITS = 8                       # blocks of a portable cluster
# Block tiles (rows of A, columns of the output) the source instantiates,
# largest first: the two `plan` picks at the int8 path's shapes.
TILES = ((64, 32), (16, 32))
# Blocks a launch may put on each SM before it counts as a second wave:
# on an H100 SXM, 4.5 a SM ran in the time of one wave and 6 did not
# (`compare_kernels.py --sweep` at the int8 path's shapes).
RESIDENT = 5
ALIGN = 16                           # bytes: the cp.async route's row and base alignment

_COUNTER = LaunchCounter("int8_matmul")
_ROUTE_COUNTER = LaunchCounter("one_pass", "split_k", "a_cp_async", "a_words",
                               routes=True)
LAUNCHES: Dict[str, int] = _COUNTER.counts
launch_counts = _COUNTER.snapshot
route_counts = _ROUTE_COUNTER.snapshot


def reset_launch_counts() -> None:
    _COUNTER.reset()
    _ROUTE_COUNTER.reset()


@dataclass(frozen=True)
class Plan:
    """One launch: block tile ``bm`` × ``bn``, k cut into ``splits`` runs of
    ``k_split`` bytes (the last one shorter), ``grid`` = (output tiles,
    1, splits), the column tile fastest along x."""
    bm: int
    bn: int
    k_split: int
    splits: int
    grid: Tuple[int, int, int]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def plan(m: int, n: int, k: int) -> Plan:
    """The launch for an (m, k) × (k, n) product.

    These GEMMs are small, so a block's time is a chain of memory
    latencies: one per k step it walks and, with k split, about two for
    the cluster's two barriers and one per partial its first block adds.
    Among the tiles no taller than m rounded up to 16 and the splits of k
    into at most `MAX_SPLITS` runs of whole 32-byte steps, take the least
    of, in order: launching fewer than `SMS` blocks; ``waves × (steps a
    block + (splits + 2 if split))``, a wave being what `RESIDENT` lets
    the SMs hold at once; the padded output area; the splits; then the
    most blocks (more loads in flight), then the larger tile.  Cached:
    the search costs tens of µs of host time, once per shape."""
    steps = max(1, _cdiv(k, K_STEP))
    best = None
    for order, (bm, bn) in enumerate(TILES):
        if bm > 16 * _cdiv(max(m, 1), 16):
            continue
        tiles = _cdiv(m, bm) * _cdiv(n, bn)
        area = _cdiv(m, bm) * bm * _cdiv(n, bn) * bn
        for splits in sorted({_cdiv(steps, per) for per in range(1, steps + 1)}
                             & set(range(1, MAX_SPLITS + 1))):
            per = _cdiv(steps, splits)
            blocks = tiles * splits
            waves = _cdiv(blocks, SMS * RESIDENT)
            cost = waves * (per + (splits + 2 if splits > 1 else 0))
            key = (blocks < SMS, cost, area, splits, -blocks, order)
            if best is None or key < best[0]:
                best = (key, Plan(bm, bn, per * K_STEP, splits,
                                  (tiles, 1, splits)))
    return best[1]


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.int8_matmul_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, i,
                                       f, i, p]
    lib.int8_matmul_launch.restype = i


LIBRARY = CudaLibrary("int8_matmul", ("int8_matmul.cu",), _declare,
                      headers=("mma_s8.cuh", "ptx_copy.cuh", "host_launch.cuh"))


def _row_stride(a_q: torch.Tensor) -> int:
    """A's row stride in bytes; raises unless its rows are unit-stride and
    do not overlap."""
    m, k = a_q.shape
    if k > 1 and a_q.stride(1) != 1:
        raise ValueError("a_q must be contiguous within its rows (stride(1) == 1)")
    if m <= 1:                      # one row: only its alignment matters
        return _cdiv(max(k, 1), ALIGN) * ALIGN
    if a_q.stride(0) < k:
        raise ValueError(f"a_q must be contiguous or row-strided with stride(0) "
                         f">= k (got {a_q.stride(0)} < {k})")
    return a_q.stride(0)


def a_route(a_q: torch.Tensor, lda: Optional[int] = None) -> str:
    """How the kernel fills shared memory with A: ``a_cp_async`` when its
    row stride (``lda``, from `_row_stride` when not given) and base are
    multiples of `ALIGN` bytes, else ``a_words``."""
    lda = _row_stride(a_q) if lda is None else lda
    aligned = lda % ALIGN == 0 and a_q.data_ptr() % ALIGN == 0
    return "a_cp_async" if aligned else "a_words"


def int8_matmul_cuda(a_q: torch.Tensor, bt: torch.Tensor, scale: float,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(m, k) int8 (row stride ≥ k) × packed (n, ldb) int8 [+ (n,) int32]
    → (m, n) float32, in one launch."""
    if not isinstance(a_q, torch.Tensor):
        raise TypeError("a_q must be a torch.Tensor")
    if a_q.device.type != "cuda":
        raise ValueError(f"a_q must lie on a CUDA device (got {a_q.device})")
    if a_q.dtype != torch.int8:
        raise TypeError(f"a_q must be torch.int8 (got {a_q.dtype})")
    _check(bt, "bt", torch.int8, a_q.device)
    if a_q.dim() != 2 or bt.dim() != 2:
        raise ValueError(f"a_q and bt must be 2-D, got {tuple(a_q.shape)} "
                         f"and {tuple(bt.shape)}")
    m, k = a_q.shape
    n, ldb = bt.shape
    if ldb < k:
        raise ValueError(f"bt packs {ldb} values per row, a_q has k = {k}")
    if ldb % ALIGN or bt.data_ptr() % ALIGN:
        raise ValueError(f"bt must be packed by pack_weight: row stride {ldb} "
                         f"and base a multiple of {ALIGN} bytes")
    _row_stride(a_q)
    if bias is not None:
        _check(bias, "bias", torch.int32, a_q.device, (n,))
    return launch(a_q, bt, scale, bias, plan(m, n, k))


def launch(a_q: torch.Tensor, bt: torch.Tensor, scale: float,
           bias: Optional[torch.Tensor], pl: Plan) -> torch.Tensor:
    """One launch of the kernel on checked operands with the plan ``pl``
    (`int8_matmul_cuda` passes `plan`'s; `compare_kernels.py --sweep`
    passes every other)."""
    (m, k), n = a_q.shape, bt.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=a_q.device)
    if m == 0 or n == 0:
        return out
    lib = LIBRARY.load()
    lda = _row_stride(a_q)
    route = a_route(a_q, lda)
    err = lib.int8_matmul_launch(
        a_q.data_ptr(), bt.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        m, n, k, lda, bt.shape[1], pl.bm, pl.bn, pl.k_split,
        pl.splits, int(route == "a_cp_async"), float(scale), a_q.get_device(),
        torch.cuda.current_stream(a_q.device).cuda_stream)
    LIBRARY.raise_on(err, "int8_matmul")
    _COUNTER.add("int8_matmul")
    _ROUTE_COUNTER.add("split_k" if pl.splits > 1 else "one_pass")
    _ROUTE_COUNTER.add(route)
    return out
