"""CUDA inter-chunk SSD scan: build, bind, launch (``csrc/ssd_scan.cu``).

``ssd_scan_cuda(s_chunk, decay)`` → (h_prev (nc, b, h, p, n), h_final
(b, h, p, n)) in s_chunk's type, on the card: s_chunk (nc, b, h, p, n)
float32 or bfloat16, decay (nc, b, h) float32 or bfloat16, both
contiguous on one card.  The wrapper checks device, dtype, contiguity
and shape, allocates the outputs, launches on the operand's card (the C
entry point takes its index and makes it current, so a launch from any
thread reaches the card its tensors are on) and on torch's current
stream of that card and raises if the C entry point reports a CUDA
error.  It adds one to ``LAUNCHES["ssd_scan"]`` where it launches the
kernel, and nowhere else.

``ssd_scan_backward_cuda(g_prev, g_final, h_prev, decay)`` → (ds, ddecay)
launches the backward (``ssd_scan_bwd_launch``: the reverse adjoint
recurrence, and ddecay summed in a fixed order without atomics, a second
kernel summing a row's block partials when the row spans several
blocks): g_prev and h_prev (nc, b, h, p, n) in one type, g_final
(b, h, p, n) in that type or None (zero), decay (nc, b, h); ds comes back
in h_prev's type, ddecay in decay's.  It adds one to
``LAUNCHES["ssd_scan_backward"]`` per call.  CPU tensors never reach this
module.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels._build import CudaLibrary, LaunchCounter
from repro_torch.kernels._build import check_tensor as _check

_COUNTER = LaunchCounter("ssd_scan", "ssd_scan_backward")
LAUNCHES: Dict[str, int] = _COUNTER.counts
launch_counts = _COUNTER.snapshot
reset_launch_counts = _COUNTER.reset

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# State elements a block of the backward covers on its scalar route: the
# most blocks a row can take, which sizes the partial sums' scratch.
_BWD_BLOCK_ELEMS = 256


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_launch.argtypes = [p, p, p, p, i, ll, ll, i, i, i, p]
    lib.ssd_scan_launch.restype = i
    lib.ssd_scan_bwd_launch.argtypes = [p, p, p, p, p, p, p, i, ll, ll, i, i, i, p]
    lib.ssd_scan_bwd_launch.restype = i


LIBRARY = CudaLibrary("ssd_scan", ("ssd_scan.cu",), _declare,
                      headers=("host_launch.cuh",))


def ssd_scan_cuda(s_chunk: torch.Tensor, decay: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_c = decay_c·h_{c-1} + s_c over the chunks, float32 state;
    returns (state before each chunk, final state) in s_chunk's type."""
    if not isinstance(s_chunk, torch.Tensor) or s_chunk.dtype not in _DTYPES:
        raise TypeError(f"s_chunk must be a float32 or bfloat16 tensor "
                        f"(got {getattr(s_chunk, 'dtype', type(s_chunk))})")
    _check(s_chunk, "s_chunk", s_chunk.dtype, s_chunk.device)
    if s_chunk.dim() != 5:
        raise ValueError(f"s_chunk must be (nc, b, h, p, n), got "
                         f"{tuple(s_chunk.shape)}")
    if not isinstance(decay, torch.Tensor) or decay.dtype not in _DTYPES:
        raise TypeError(f"decay must be a float32 or bfloat16 tensor "
                        f"(got {getattr(decay, 'dtype', type(decay))})")
    nc, b, h, p, n = s_chunk.shape
    _check(decay, "decay", decay.dtype, s_chunk.device, (nc, b, h))
    h_prev = torch.empty_like(s_chunk)
    h_final = torch.empty((b, h, p, n), dtype=s_chunk.dtype, device=s_chunk.device)
    if h_final.numel() == 0:
        return h_prev, h_final
    lib = LIBRARY.load()
    err = lib.ssd_scan_launch(s_chunk.data_ptr(), decay.data_ptr(),
                              h_prev.data_ptr(), h_final.data_ptr(), nc, b * h,
                              p * n, _DTYPES[s_chunk.dtype], _DTYPES[decay.dtype],
                              s_chunk.get_device(),
                              torch.cuda.current_stream(s_chunk.device).cuda_stream)
    LIBRARY.raise_on(err, "ssd_scan")
    _COUNTER.add("ssd_scan")
    return h_prev, h_final


def ssd_scan_backward_cuda(g_prev: torch.Tensor, g_final: Optional[torch.Tensor],
                           h_prev: torch.Tensor, decay: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ds, ddecay) of the scan: G_{nc-1} = g_final, G_{c-1} = G_c·decay_c
    + g_prev[c], ds[c] = G_c, ddecay[c] = Σ_{p,n} G_c·h_prev[c]."""
    if not isinstance(h_prev, torch.Tensor) or h_prev.dtype not in _DTYPES:
        raise TypeError(f"h_prev must be a float32 or bfloat16 tensor "
                        f"(got {getattr(h_prev, 'dtype', type(h_prev))})")
    _check(h_prev, "h_prev", h_prev.dtype, h_prev.device)
    if h_prev.dim() != 5:
        raise ValueError(f"h_prev must be (nc, b, h, p, n), got {tuple(h_prev.shape)}")
    nc, b, h, p, n = h_prev.shape
    _check(g_prev, "g_prev", h_prev.dtype, h_prev.device, tuple(h_prev.shape))
    if g_final is not None:
        _check(g_final, "g_final", h_prev.dtype, h_prev.device, (b, h, p, n))
    if not isinstance(decay, torch.Tensor) or decay.dtype not in _DTYPES:
        raise TypeError(f"decay must be a float32 or bfloat16 tensor "
                        f"(got {getattr(decay, 'dtype', type(decay))})")
    _check(decay, "decay", decay.dtype, h_prev.device, (nc, b, h))
    ds = torch.empty_like(h_prev)
    ddecay = torch.empty_like(decay)
    if ds.numel() == 0:
        return ds, ddecay.zero_()
    stretches = -(-(p * n) // _BWD_BLOCK_ELEMS)
    partial = torch.empty(nc * b * h * stretches, dtype=torch.float32,
                          device=h_prev.device)
    lib = LIBRARY.load()
    err = lib.ssd_scan_bwd_launch(
        g_prev.data_ptr(), None if g_final is None else g_final.data_ptr(),
        h_prev.data_ptr(), decay.data_ptr(), ds.data_ptr(), partial.data_ptr(),
        ddecay.data_ptr(), nc, b * h, p * n, _DTYPES[h_prev.dtype],
        _DTYPES[decay.dtype], h_prev.get_device(),
        torch.cuda.current_stream(h_prev.device).cuda_stream)
    LIBRARY.raise_on(err, "ssd_scan_backward")
    _COUNTER.add("ssd_scan_backward")
    return ds, ddecay
