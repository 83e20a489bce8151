"""The backward's device time a profiled step, with its recompute: the
device's busy time a profiled step (the union of its intervals) less
`trainstep.forward_ms` and `trainstep.optimizer_ms`.  It also holds the
little the step runs outside those spans (the batch's copy, the
gradients' zero fill)."""
from portbench.spans import device_ms

UNIT = "ms"


def read(ctx):
    forward = device_ms(ctx, "train.forward")
    optimizer = device_ms(ctx, "train.optimizer")
    if forward is None or optimizer is None or not ctx.trace.device:
        return None
    return 1e3 * ctx.trace.busy_s() / ctx.trace.steps - forward - optimizer
