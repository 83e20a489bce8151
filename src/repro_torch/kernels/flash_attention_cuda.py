"""CUDA flash attention: build, bind, launch (``csrc/flash_attention.cu``).

``flash_attention_cuda(q, k, v, causal, q_offset, window, softcap)`` →
(b, sq, h, d) in q's type, on the card: q (b, sq, h, d), k and v
(b, skv, kvh, d), contiguous and 16-byte aligned, all float32 or all
bfloat16, d in `HEAD_DIMS`; the masks and the softcap are those of
`repro_torch.kernels.flash_attention`.  The kernels skip the key tiles a
window hides, so a query row that sees no key at all (``sq + q_offset -
window >= skv``) is refused: its plain result averages all of V.  The
type picks the kernel: bfloat16 launches the tensor-core kernel
(`flash_fwd_bf16_mma`), float32 the CUDA-core one (`flash_fwd`); there
is no fallback between them.  The wrapper checks
device, dtype, contiguity and shape, allocates the output, launches on
the operand's card (the C entry point takes its index and makes it
current, so a launch from any thread reaches the card its tensors are
on) and on torch's current stream of that card and raises if the C entry
point reports a CUDA error.  It adds one to
``LAUNCHES["flash_attention"]`` (every launch) and to
``route_counts()[route]`` (the kernel's route, `ROUTES`) where it
launches, and nowhere else.  With ``return_lse=True`` it also returns
each row's float32 log-sum-exp, (b, h, sq), which the training path
saves for the backward.

``flash_attention_backward_cuda(q, k, v, o, lse, do, causal, q_offset,
window, softcap)`` → (dq, dk, dv) in q's type launches the hand-written
backward (``csrc/flash_attention_bwd.cu``: a dq pass that also writes
each row's D = dO·O, then a dk/dv pass over every query head of a kv
head's group), with the forward's masks and softcap and the same refusal
of a row that sees no key.  The type picks the route as in the forward:
bfloat16 the tensor-core kernels (`flash_bwd_dq_bf16_mma`,
`flash_bwd_dkdv_bf16_mma`), float32 the CUDA-core ones (`flash_bwd_dq`,
`flash_bwd_dkdv`).  It adds one to ``LAUNCHES["flash_attention_backward"]``
and to ``bwd_route_counts()[route]`` per call (the one C entry point runs
both passes).  CPU tensors never reach this module.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels._build import CudaLibrary, LaunchCounter
from repro_torch.kernels._build import check_tensor as _check

# dtype → (code of the C entry point, route of the kernel it launches).
ROUTES = {torch.float32: (0, "f32_simt"), torch.bfloat16: (1, "bf16_mma")}
_COUNTER = LaunchCounter("flash_attention", "flash_attention_backward")
_ROUTE_COUNTER = LaunchCounter(*(r for _, r in ROUTES.values()), routes=True)
# The backward's launches by route (the same `ROUTES`).
_BWD_ROUTE_COUNTER = LaunchCounter(*(r for _, r in ROUTES.values()), routes=True)
LAUNCHES: Dict[str, int] = _COUNTER.counts
launch_counts = _COUNTER.snapshot
route_counts = _ROUTE_COUNTER.snapshot
bwd_route_counts = _BWD_ROUTE_COUNTER.snapshot

# Head dimensions the kernels are compiled for (one instance each).
HEAD_DIMS = (16, 32, 64, 128)


def reset_launch_counts() -> None:
    _COUNTER.reset()
    _ROUTE_COUNTER.reset()
    _BWD_ROUTE_COUNTER.reset()


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                           i, i, i, i, f, f, i, p]
    lib.flash_attention_launch.restype = i
    lib.flash_attention_bf16_smem_bytes.argtypes = [i]
    lib.flash_attention_bf16_smem_bytes.restype = i


def _declare_bwd(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_bwd_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i,
                                               i, i, i, i, i, i, i, f, f, i, p]
    lib.flash_attention_bwd_launch.restype = i
    lib.flash_attention_bwd_smem_bytes.argtypes = [i]
    lib.flash_attention_bwd_smem_bytes.restype = i
    lib.flash_attention_bwd_bf16_smem_bytes.argtypes = [i, i]
    lib.flash_attention_bwd_bf16_smem_bytes.restype = i


LIBRARY = CudaLibrary("flash_attention", ("flash_attention.cu",), _declare,
                      headers=("mma_bf16.cuh", "ptx_copy.cuh", "host_launch.cuh"))
BWD_LIBRARY = CudaLibrary("flash_attention_bwd", ("flash_attention_bwd.cu",),
                          _declare_bwd,
                          headers=("mma_bf16.cuh", "ptx_copy.cuh", "host_launch.cuh"))
# Every library of the module, built together by `_build.build_all`.
LIBRARIES = (LIBRARY, BWD_LIBRARY)


def check_masks(window: int, softcap: float) -> None:
    """The window and softcap rule of both the kernel and its plain
    version."""
    if window < 0 or not 0 <= softcap < math.inf:
        raise ValueError(f"window must be >= 0 and softcap finite and >= 0 "
                         f"(got {window}, {softcap})")


def _check_seen(sq: int, skv: int, q_offset: int, window: int) -> None:
    """The kernels skip the key tiles a window hides, so a query row that
    sees no key (its plain result averages all of V) is refused."""
    if window and sq + q_offset - window >= skv:
        raise ValueError(f"a window of {window} hides every key from the last "
                         f"query rows (sq {sq}, q_offset {q_offset}, skv {skv})")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, q_offset: int = 0, window: int = 0,
                         softcap: float = 0.0, return_lse: bool = False):
    """q (b, sq, h, d), k and v (b, skv, kvh, d) → (b, sq, h, d), and with
    ``return_lse`` also the rows' float32 log-sum-exp (b, h, sq)."""
    if q.dtype not in ROUTES:
        raise TypeError(f"q must be float32 or bfloat16 (got {q.dtype})")
    _check(q, "q", q.dtype, q.device)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-D, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    _check(k, "k", q.dtype, q.device, (b, skv, kvh, d))
    _check(v, "v", q.dtype, q.device, (b, skv, kvh, d))
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (one of {HEAD_DIMS})")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0 (got {q_offset})")
    check_masks(window, softcap)
    _check_seen(sq, skv, q_offset, window)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"reads 16-byte vectors)")
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    if skv == 0:
        raise ValueError("attention over an empty key sequence")
    lib = LIBRARY.load()
    code, route = ROUTES[q.dtype]
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None,
        b, sq, skv, h, kvh, d, code, int(causal), int(q_offset), int(window),
        float(softcap), 1.0 / math.sqrt(d), q.get_device(),
        torch.cuda.current_stream(q.device).cuda_stream)
    LIBRARY.raise_on(err, "flash_attention")
    _COUNTER.add("flash_attention")
    _ROUTE_COUNTER.add(route)
    return (out, lse) if return_lse else out


def flash_attention_backward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  o: torch.Tensor, lse: torch.Tensor,
                                  do: torch.Tensor, *, causal: bool = True,
                                  q_offset: int = 0, window: int = 0,
                                  softcap: float = 0.0):
    """(dq, dk, dv) of attention: q, o and do (b, sq, h, d), k and v
    (b, skv, kvh, d) in one type, lse float32 (b, h, sq) from the forward
    with the same masks and softcap."""
    if q.dtype not in ROUTES:
        raise TypeError(f"q must be float32 or bfloat16 (got {q.dtype})")
    _check(q, "q", q.dtype, q.device)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-D, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    _check(k, "k", q.dtype, q.device, (b, skv, kvh, d))
    _check(v, "v", q.dtype, q.device, (b, skv, kvh, d))
    _check(o, "o", q.dtype, q.device, (b, sq, h, d))
    _check(do, "do", q.dtype, q.device, (b, sq, h, d))
    _check(lse, "lse", torch.float32, q.device, (b, h, sq))
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (one of {HEAD_DIMS})")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0 (got {q_offset})")
    check_masks(window, softcap)
    _check_seen(sq, skv, q_offset, window)
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = BWD_LIBRARY.load()
    code, route = ROUTES[q.dtype]
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, sq, skv, h, kvh, d, code, int(causal), int(q_offset),
        int(window), float(softcap), 1.0 / math.sqrt(d), q.get_device(),
        torch.cuda.current_stream(q.device).cuda_stream)
    BWD_LIBRARY.raise_on(err, "flash_attention_backward")
    _COUNTER.add("flash_attention_backward")
    _BWD_ROUTE_COUNTER.add(route)
    return dq, dk, dv
