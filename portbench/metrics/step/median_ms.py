"""The median of the window's step times (CUDA events around each step)."""
import statistics

UNIT = "ms"


def read(ctx):
    return statistics.median(ctx.step_ms) if ctx.step_ms else None
