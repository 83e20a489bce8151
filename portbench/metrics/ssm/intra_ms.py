"""The SSD's intra-chunk device time a profiled step: the program's
``ssm.intra`` span (the weights w and y_intra of `ssd_forward`), forward
and recompute, and its backward ``ssm.intra.bwd``."""
from portbench.spans import device_ms

UNIT = "ms"


def read(ctx):
    return device_ms(ctx, "ssm.intra", "ssm.intra.bwd")
