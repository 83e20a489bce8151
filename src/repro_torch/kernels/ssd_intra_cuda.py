"""CUDA intra-chunk SSD output: build, bind, launch (``csrc/ssd_intra.cu``).

``ssd_intra_cuda(x, dt, cum, cb)`` → y (b, c, q, h, p): x (b, c, q, h, p),
dt and cum (b, c, q, h), cb = C·Bᵀ (b, c, q, q), all float32, contiguous,
on one card, p = 64.  The weights w[t, s] = exp(cum_t − cum_s)·cb[t, s]·dt_s
are built tile by tile in shared memory and never written to the card's
memory.  ``ssd_intra_backward_cuda(dy, x, dt, cum, cb)`` → (dx, d dt, d cum,
d cb) in the inputs' shapes: four kernels in one call (dx; dw and its tile
partials; the partials summed in a fixed order, twice), no atomics.

The wrappers check device, dtype, contiguity and shape, allocate the
outputs and the backward's float32 scratch, launch on the operands' card
(the C entry points take its index and make it current) and on torch's
current stream of that card, and raise if a C entry point reports a CUDA
error.  They add one to ``LAUNCHES["ssd_intra"]`` or
``LAUNCHES["ssd_intra_backward"]`` per call, and nowhere else.  CPU tensors
never reach this module.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels._build import CudaLibrary, LaunchCounter
from repro_torch.kernels._build import check_tensor as _check

_COUNTER = LaunchCounter("ssd_intra", "ssd_intra_backward")
LAUNCHES: Dict[str, int] = _COUNTER.counts
launch_counts = _COUNTER.snapshot
reset_launch_counts = _COUNTER.reset

# The head dims the kernels are built for (one template instance each).
HEAD_DIMS = (64,)
# Rows (t and s) of one tile: the partial sums are kept per tile.
TILE = 64
# Heads a block of the dw pass loops over: its d cb partial is summed over
# them in registers, and the groups' partials in a fixed order after.
HEADS_PER_GROUP = 16


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_intra_launch.argtypes = [p, p, p, p, p, ll, i, i, i, i, p]
    lib.ssd_intra_launch.restype = i
    lib.ssd_intra_bwd_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, p,
                                         ll, i, i, i, i, i, p]
    lib.ssd_intra_bwd_launch.restype = i


LIBRARY = CudaLibrary("ssd_intra", ("ssd_intra.cu",), _declare,
                      headers=("host_launch.cuh",))


def _check_inputs(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                  cb: torch.Tensor) -> Tuple[int, int, int, int, int]:
    if not isinstance(x, torch.Tensor):
        raise TypeError("x must be a torch.Tensor")
    _check(x, "x", torch.float32, x.device)
    if x.dim() != 5:
        raise ValueError(f"x must be (b, c, q, h, p), got {tuple(x.shape)}")
    b, c, q, h, p = x.shape
    if p not in HEAD_DIMS:
        raise ValueError(f"ssd_intra_cuda is built for head dims {HEAD_DIMS}, got {p}")
    _check(dt, "dt", torch.float32, x.device, (b, c, q, h))
    _check(cum, "cum", torch.float32, x.device, (b, c, q, h))
    _check(cb, "cb", torch.float32, x.device, (b, c, q, q))
    return b, c, q, h, p


def ssd_intra_cuda(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                   cb: torch.Tensor) -> torch.Tensor:
    """y[t] = Σ_s w[t, s]·x[s] within each chunk, the tiles above the
    diagonal skipped; y in x's layout (b, c, q, h, p)."""
    b, c, q, h, p = _check_inputs(x, dt, cum, cb)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lib = LIBRARY.load()
    err = lib.ssd_intra_launch(x.data_ptr(), dt.data_ptr(), cum.data_ptr(),
                               cb.data_ptr(), y.data_ptr(), b * c, q, h, p,
                               x.get_device(),
                               torch.cuda.current_stream(x.device).cuda_stream)
    LIBRARY.raise_on(err, "ssd_intra")
    _COUNTER.add("ssd_intra")
    return y


def ssd_intra_backward_cuda(dy: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                            cum: torch.Tensor, cb: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(dx, d dt, d cum, d cb) of `ssd_intra_cuda` at the gradient dy of
    its output."""
    b, c, q, h, p = _check_inputs(x, dt, cum, cb)
    _check(dy, "dy", torch.float32, x.device, tuple(x.shape))
    dx = torch.empty_like(x)
    ddt, dcum, dcb = torch.empty_like(dt), torch.empty_like(cum), torch.empty_like(cb)
    if dx.numel() == 0:
        return dx, ddt.zero_(), dcum.zero_(), dcb.zero_()
    tiles = -(-q // TILE)
    groups = -(-h // HEADS_PER_GROUP)
    rowpart, colcum, colddt = torch.empty((3, b * c * tiles * h * q),
                                          dtype=torch.float32, device=x.device)
    cbpart = torch.empty(b * c * groups * q * q, dtype=torch.float32, device=x.device)
    lib = LIBRARY.load()
    err = lib.ssd_intra_bwd_launch(
        dy.data_ptr(), x.data_ptr(), dt.data_ptr(), cum.data_ptr(), cb.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), dcum.data_ptr(), dcb.data_ptr(),
        rowpart.data_ptr(), colcum.data_ptr(), colddt.data_ptr(), cbpart.data_ptr(),
        b * c, q, h, p, HEADS_PER_GROUP, x.get_device(),
        torch.cuda.current_stream(x.device).cuda_stream)
    LIBRARY.raise_on(err, "ssd_intra_backward")
    _COUNTER.add("ssd_intra_backward")
    return dx, ddt, dcum, dcb
