"""CUDA int8 GEMM: build, bind, launch (``csrc/int8_matmul.cu``).

``int8_matmul_cuda(a_q, bt, scale, bias)`` → (m, n) float32
``f32(a_q · btᵀ + bias) · scale`` on the card, where ``bt`` is the weight
prepacked by `repro_torch.kernels.int8_matmul.pack_weight`.  The wrapper
checks device, dtype, contiguity and shape, allocates the output, launches
on torch's current stream and raises if the C entry point reports a CUDA
error.  It adds one to ``LAUNCHES["int8_matmul"]`` where it launches the
kernel, and nowhere else.  CPU tensors never reach this module.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels._build import CudaLibrary, LaunchCounter
from repro_torch.kernels._build import check_tensor as _check

_COUNTER = LaunchCounter("int8_matmul")
LAUNCHES: Dict[str, int] = _COUNTER.counts
launch_counts = _COUNTER.snapshot
reset_launch_counts = _COUNTER.reset


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.int8_matmul_launch.argtypes = [p, p, p, p, i, i, i, i, f, p]
    lib.int8_matmul_launch.restype = i


LIBRARY = CudaLibrary("int8_matmul", ("int8_matmul.cu",), _declare)


def int8_matmul_cuda(a_q: torch.Tensor, bt: torch.Tensor, scale: float,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(m, k) int8 × packed (n, ldb) int8 [+ (n,) int32] → (m, n) float32."""
    _check(a_q, "a_q", torch.int8, a_q.device)
    _check(bt, "bt", torch.int8, a_q.device)
    if a_q.dim() != 2 or bt.dim() != 2:
        raise ValueError(f"a_q and bt must be 2-D, got {tuple(a_q.shape)} "
                         f"and {tuple(bt.shape)}")
    m, k = a_q.shape
    n, ldb = bt.shape
    if ldb < k:
        raise ValueError(f"bt packs {ldb} values per row, a_q has k = {k}")
    if bias is not None:
        _check(bias, "bias", torch.int32, a_q.device, (n,))
    out = torch.empty((m, n), dtype=torch.float32, device=a_q.device)
    if m == 0 or n == 0:
        return out
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(a_q.device).cuda_stream
    err = lib.int8_matmul_launch(
        a_q.data_ptr(), bt.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        m, n, k, ldb, float(scale), stream)
    LIBRARY.raise_on(err, "int8_matmul")
    _COUNTER.add("int8_matmul")
    return out
