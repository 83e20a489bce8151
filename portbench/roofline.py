"""A kernel op's share of its roofline, from a profiled stretch of steps."""
from __future__ import annotations

from typing import Optional

from portbench.core import Context, least_time_s


def share_pct(ctx: Context, count: str) -> Optional[float]:
    """100 × (the least time of every call of the count's ops, each at its
    own shapes) ÷ (the device time of the kernels those calls launched);
    None where the trace holds no such call or no device time for them."""
    if ctx.trace is None:
        return None
    mod = ctx.count(count)
    calls = [c for op in mod.OPS for c in ctx.trace.calls(op)]
    device_s = sum(c.device_us for c in calls) / 1e6
    if not calls or device_s <= 0:
        return None
    least = sum(least_time_s(*mod.work(c.name, c.input_shapes, ctx.cell.config["arch"]),
                             ctx.peaks, mod.PEAK) for c in calls)
    return 100.0 * least / device_s
