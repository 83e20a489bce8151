"""Wall-clock timing helpers for profiling torch callables.

Methodology (mirrors the paper's §4.3.1 amortized profiling, and the
reference's ``repro.utils.timing``):
  * warm up (first-call allocation, cuDNN algorithm choice, caches),
  * run `inner` iterations back-to-back between two timestamps, blocking
    only on the final result (amortizes launch overhead, like the paper's
    256-dispatch OpenCL batch),
  * repeat `repeats` times and take the minimum (least-noise estimator).

Blocking on the card is ``torch.cuda.synchronize()``: kernel launches
return before the device finishes, so a host clock read without it
measures the enqueue, not the work.  CPU tensors need no block.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Iterator, Sequence

import torch


def _leaves(x: Any) -> Iterator[Any]:
    if isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def _block(x: Any) -> None:
    """Wait for the devices holding any CUDA tensor in ``x``."""
    seen = set()
    for leaf in _leaves(x):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda \
                and leaf.device not in seen:
            seen.add(leaf.device)
            torch.cuda.synchronize(leaf.device)


def time_callable(
    fn: Callable[..., Any],
    args: Sequence[Any] = (),
    *,
    warmup: int = 2,
    inner: int = 4,
    repeats: int = 3,
) -> float:
    """Return estimated seconds per call of ``fn(*args)`` (min over repeats).

    ``warmup=0`` is honored — no warm-up iterations run, so the first
    timed repeat pays first-call costs (deliberate for cold-start studies).
    The inputs are synchronized before the first timestamp, so work that
    produced them is never billed to ``fn``.
    """
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _block((out, args))
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args)
        _block(out)
        dt = (time.perf_counter() - t0) / inner
        best = min(best, dt)
    return best


def time_sequential(
    fns_args: Sequence[tuple],
    *,
    warmup: int = 1,
    inner: int = 2,
    repeats: int = 3,
) -> float:
    """Time a *sequence* of (fn, args) dispatched back-to-back (end-to-end).

    This mirrors sequential op execution on a TFLite CPU interpreter:
    python-level dispatch overhead is part of the measurement.
    """
    def run_once():
        out = None
        for fn, args in fns_args:
            out = fn(*args)
        return out

    out = None
    for _ in range(warmup):
        out = run_once()
    _block((out, [a for _, a in fns_args]))
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = run_once()
        _block(out)
        best = min(best, (time.perf_counter() - t0) / inner)
    return best
