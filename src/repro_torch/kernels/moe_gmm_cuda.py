"""CUDA grouped expert matmul: build, bind, launch (``csrc/moe_gmm.cu``).

``moe_gmm_cuda(x, w)`` → (e, c, f) in x's type: x (e, c, d) × w (e, d, f),
contiguous, both float32 or both bfloat16, on the card.  The type picks
the kernel: bfloat16 launches the tensor-core kernel
(`moe_gmm_mma_kernel`, its tile chosen from c), float32 the CUDA-core one
(`moe_gmm_kernel`); there is no fallback between them.  The wrapper
checks device, dtype, contiguity and shape, allocates the output,
launches on the operand's card (the C entry point takes its index and
makes it current, so a launch from any thread reaches the card its
tensors are on) and on torch's current stream of that card and raises if
the C entry point reports a CUDA error.  It adds one to
``LAUNCHES["moe_gmm"]`` (every launch) and to ``route_counts()[route]``
(the kernel's route, `ROUTES`) where it launches, and nowhere else.  CPU
tensors never reach this module.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels._build import CudaLibrary, LaunchCounter
from repro_torch.kernels._build import check_tensor as _check

# dtype → (code of the C entry point, route of the kernel it launches).
ROUTES = {torch.float32: (0, "f32_simt"), torch.bfloat16: (1, "bf16_mma")}
_COUNTER = LaunchCounter("moe_gmm")
_ROUTE_COUNTER = LaunchCounter(*(r for _, r in ROUTES.values()), routes=True)
LAUNCHES: Dict[str, int] = _COUNTER.counts
launch_counts = _COUNTER.snapshot
route_counts = _ROUTE_COUNTER.snapshot


def reset_launch_counts() -> None:
    _COUNTER.reset()
    _ROUTE_COUNTER.reset()


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.moe_gmm_launch.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.moe_gmm_launch.restype = i
    lib.moe_gmm_bf16_smem_bytes.argtypes = [i]
    lib.moe_gmm_bf16_smem_bytes.restype = i


LIBRARY = CudaLibrary("moe_gmm", ("moe_gmm.cu",), _declare,
                      headers=("mma_bf16.cuh", "ptx_copy.cuh", "host_launch.cuh"))


def moe_gmm_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(e, c, d) × (e, d, f) → (e, c, f), float32 sums, x's type out."""
    if x.dtype not in ROUTES:
        raise TypeError(f"x must be float32 or bfloat16 (got {x.dtype})")
    _check(x, "x", x.dtype, x.device)
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x and w must be 3-D, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    e, c, d = x.shape
    f = w.shape[2]
    _check(w, "w", x.dtype, x.device, (e, d, f))
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = LIBRARY.load()
    code, route = ROUTES[x.dtype]
    err = lib.moe_gmm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                             e, c, d, f, code, x.get_device(),
                             torch.cuda.current_stream(x.device).cuda_stream)
    LIBRARY.raise_on(err, "moe_gmm")
    _COUNTER.add("moe_gmm")
    _ROUTE_COUNTER.add(route)
    return out
