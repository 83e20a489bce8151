"""What the readers of the program's own spans share.

A training step of the port traced under `torch.profiler` carries spans
(`repro_torch.obs.tracing`: ``train.step``, ``train.forward``,
``moe.route`` …) that the profiler lists as ops of the same name, on
its own clock: each with the device time of the kernels launched under
it, and its host interval.  The spans' counters stay in the program's
tracer, the process-wide `repro_torch.obs.default()` bundle that the
step uses when it is given none.  A program without such spans gives
these readers nothing to read: they return None."""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from portbench.core import Context


def device_ms(ctx: Context, *names: str) -> Optional[float]:
    """The device time (ms) a profiled step of the ops named ``names``:
    the kernels launched under each, its nested spans' included; None
    where the trace holds none of them."""
    if ctx.trace is None:
        return None
    calls = [c for name in names for c in ctx.trace.calls(name)]
    if not calls:
        return None
    return sum(c.device_us for c in calls) / 1e3 / ctx.trace.steps


def host_ms(ctx: Context, name: str) -> Optional[float]:
    """The host time (ms) a profiled step inside the ops named ``name``;
    None where the trace holds none."""
    if ctx.trace is None:
        return None
    spans = [e - s for n, s, e in ctx.trace.host if n == name]
    if not spans:
        return None
    return sum(spans) / 1e3 / ctx.trace.steps


def program_spans() -> Optional[List[Dict[str, Any]]]:
    """The finished spans of the program's default tracer, counters read;
    None where the program has no such tracer."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    default = getattr(obs, "default", None)
    return None if default is None else default().tracer.export()


def last_steps(steps: int) -> List[Dict[str, Any]]:
    """The program's spans of its last ``steps`` traced steps (one trace
    id a ``train.step``): the profiled steps of a run."""
    found = program_spans() or []
    tids = [s["tid"] for s in found if s["name"] == "train.step"][-steps:]
    return [s for s in found if s["tid"] in tids]
