"""The MoE dispatch's device time a profiled step: the program's
``moe.route``, ``moe.dispatch`` and ``moe.combine`` spans, forward and
recompute, and the backwards ``moe.dispatch.bwd`` and ``moe.combine.bwd``."""
from portbench.spans import device_ms

UNIT = "ms"
SPANS = ("moe.route", "moe.dispatch", "moe.combine", "moe.dispatch.bwd", "moe.combine.bwd")


def read(ctx):
    return device_ms(ctx, *SPANS)
