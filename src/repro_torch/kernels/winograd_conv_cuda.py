"""CUDA Winograd F(2×2,3×3) tiles: build, bind, launch
(``csrc/winograd_conv.cu``).

``winograd_tiles_cuda(tiles, u)`` → (T, 4, K) float32 output tiles from
(T, 16, C) float32 input tiles and (16, C, K) pre-transformed weights, on
the card.  The wrapper checks device, dtype, contiguity and shape,
allocates the output, launches on torch's current stream and raises if
the C entry point reports a CUDA error.  It adds one to
``LAUNCHES["winograd_conv2d"]`` where it launches the kernel, and nowhere
else.  CPU tensors never reach this module.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels._build import CudaLibrary, LaunchCounter
from repro_torch.kernels._build import check_tensor as _check

_COUNTER = LaunchCounter("winograd_conv2d")
LAUNCHES: Dict[str, int] = _COUNTER.counts
launch_counts = _COUNTER.snapshot
reset_launch_counts = _COUNTER.reset


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.winograd_conv_launch.argtypes = [p, p, p, i, i, i, p]
    lib.winograd_conv_launch.restype = i


LIBRARY = CudaLibrary("winograd_conv", ("winograd_conv.cu",), _declare)


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
    out = torch.empty((t, 4, k), dtype=torch.float32, device=tiles.device)
    if t == 0 or k == 0:
        return out
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(tiles.device).cuda_stream
    err = lib.winograd_conv_launch(tiles.data_ptr(), u.data_ptr(),
                                   out.data_ptr(), t, c, k, stream)
    LIBRARY.raise_on(err, "winograd_conv2d")
    _COUNTER.add("winograd_conv2d")
    return out
