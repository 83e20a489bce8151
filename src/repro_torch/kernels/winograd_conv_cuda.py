"""CUDA Winograd F(2×2,3×3) tiles: plan, build, bind, launch
(``csrc/winograd_conv.cu``).

``winograd_tiles_cuda(tiles, u)`` → (T, 4, K) float32 output tiles from
(T, 16, C) float32 input tiles and (16, C, K) pre-transformed weights, on
the card.  One call is two device launches: the 16 per-position
products into a (16, T, K) float32 workspace (``torch.empty``), then the
output transform.  Where that workspace would pass `WORKSPACE_BYTES`,
the call runs both launches on runs of ``Plan.t_pass`` tiles that reuse
one workspace of that size, two launches a run.  `plan` picks the block
tile of the first launch and the run length (pure Python, so the CPU
tests hold it).

The wrapper checks device, dtype, contiguity and shape, allocates the
output, launches on the operand's card (the C entry point takes its
index and makes it current, so a launch from any thread reaches the card
its tensors are on) and on torch's current stream of that card and
raises if the C entry point reports a CUDA error.  It adds one to
``LAUNCHES["winograd_conv2d"]`` per call where it launches the kernels,
and nowhere else; ``route_counts()`` counts the same calls by block tile
and step (``t16_q128_c16`` … ``t16_q64_c32``).  CPU tensors never reach
this module.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.kernels._build import CudaLibrary, LaunchCounter
from repro_torch.kernels._build import check_tensor as _check

SMS = 132                            # streaming multiprocessors of an H100 SXM
POSITIONS = 16                       # the 4×4 Winograd grid: blockIdx.z
# Block tiles (tiles, output channels) and chunk depths (input channels a
# step) the source instantiates, largest first: the tiles `plan` picks at
# the study shapes.
TILES = ((16, 128), (16, 64))
CHUNKS = (32, 16)
# Input channels from which a step of 32 beat a step of 16 on an H100 SXM
# (`compare_kernels.py --sweep` at the study shapes).
DEEP_CHUNK_MIN_C = 128
# Most bytes of M workspace a call allocates: half of an H100's 50 MB L2,
# where the output pass finds it.
WORKSPACE_BYTES = 32 << 20

_COUNTER = LaunchCounter("winograd_conv2d")
_ROUTE_COUNTER = LaunchCounter(*(f"t{bt}_q{bq}_c{cc}" for bt, bq in TILES
                                 for cc in CHUNKS), routes=True)
LAUNCHES: Dict[str, int] = _COUNTER.counts
launch_counts = _COUNTER.snapshot
route_counts = _ROUTE_COUNTER.snapshot


def reset_launch_counts() -> None:
    _COUNTER.reset()
    _ROUTE_COUNTER.reset()


@dataclass(frozen=True)
class Plan:
    """The products launch: ``bt`` tiles × ``bq`` output channels a block,
    ``cc`` input channels a step, runs of ``t_pass`` tiles, ``grid`` =
    (tile blocks, channel blocks, 16 positions) of one full run."""
    bt: int
    bq: int
    cc: int
    t_pass: int
    grid: Tuple[int, int, int]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def route(self) -> str:
        return f"t{self.bt}_q{self.bq}_c{self.cc}"


@functools.lru_cache(maxsize=None)
def plan(t: int, c: int, k: int) -> Plan:
    """Runs of as many tiles as `WORKSPACE_BYTES` of M hold (all T when
    they fit).  Among the tiles that give a run at least `SMS` blocks (all
    tiles when none does), the one that pads the run's tiles and K least;
    ties go to the earlier tile of `TILES`.  Steps of 32 input channels
    from `DEEP_CHUNK_MIN_C` on, else 16.  Cached per shape."""
    cc = CHUNKS[0] if c >= DEEP_CHUNK_MIN_C else CHUNKS[1]
    t_pass = max(1, min(t, WORKSPACE_BYTES // (POSITIONS * 4 * max(k, 1))))
    plans = [Plan(bt, bq, cc, t_pass, (-(-t_pass // bt), -(-k // bq), POSITIONS))
             for bt, bq in TILES]
    full = [p for p in plans if p.blocks >= SMS] or plans
    return min(full, key=lambda p: p.grid[0] * p.bt * p.grid[1] * p.bq)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.winograd_conv_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.winograd_conv_launch.restype = i


LIBRARY = CudaLibrary("winograd_conv", ("winograd_conv.cu",), _declare,
                      headers=("ptx_copy.cuh", "host_launch.cuh"))


def winograd_tiles_cuda(tiles: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(T, 16, C) f32 tiles × (16, C, K) f32 weights → (T, 4, K) f32."""
    _check(tiles, "tiles", torch.float32, tiles.device)
    if tiles.dim() != 3 or tiles.shape[1] != 16:
        raise ValueError(f"tiles must have shape (T, 16, C), got {tuple(tiles.shape)}")
    t, _, c = tiles.shape
    if u.dim() != 3:
        raise ValueError(f"u must have shape (16, {c}, K), got {tuple(u.shape)}")
    k = u.shape[2]
    _check(u, "u", torch.float32, tiles.device, (16, c, k))
    return launch(tiles, u, plan(t, c, k))


def launch(tiles: torch.Tensor, u: torch.Tensor, pl: Plan) -> torch.Tensor:
    """The launches on checked operands with the plan ``pl``
    (`winograd_tiles_cuda` passes `plan`'s; `compare_kernels.py --sweep`
    passes every other)."""
    (t, _, c), k = tiles.shape, u.shape[2]
    out = torch.empty((t, 4, k), dtype=torch.float32, device=tiles.device)
    if t == 0 or k == 0:
        return out
    lib = LIBRARY.load()
    mws = torch.empty((POSITIONS, min(t, pl.t_pass), k), dtype=torch.float32,
                      device=tiles.device)
    err = lib.winograd_conv_launch(
        tiles.data_ptr(), u.data_ptr(), out.data_ptr(), mws.data_ptr(), t,
        pl.t_pass, c, k, pl.bt, pl.bq, pl.cc, tiles.get_device(),
        torch.cuda.current_stream(tiles.device).cuda_stream)
    LIBRARY.raise_on(err, "winograd_conv2d")
    _COUNTER.add("winograd_conv2d")
    _ROUTE_COUNTER.add(pl.route)
    return out
