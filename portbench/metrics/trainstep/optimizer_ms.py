"""The optimizer's device time a profiled step: the kernels launched under
the program's ``train.optimizer`` span (the rate's schedule, AdamW's
norm, clip and leaf loop)."""
from portbench.spans import device_ms

UNIT = "ms"


def read(ctx):
    return device_ms(ctx, "train.optimizer")
