"""The share of a step in which no operation runs on the device: the
profiled steps' device time (the union of the trace's device intervals)
a step, against the window's median step (CUDA events, no profiler).
The profiler slows the host, so the profiled steps' own wall time
(`busy_s` against `window_s` in the result's ``device``) reads more idle
than a step of the window has."""
import statistics

UNIT = "%"


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or not ctx.step_ms:
        return None
    busy_ms = 1e3 * ctx.trace.busy_s() / ctx.trace.steps
    return 100.0 * (1.0 - busy_ms / statistics.median(ctx.step_ms))
