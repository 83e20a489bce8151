"""The forward's device time a profiled step: the kernels launched under
the program's ``train.forward`` span (the loss, with every layer's first
pass, the MoE dispatch and the loss head)."""
from portbench.spans import device_ms

UNIT = "ms"


def read(ctx):
    return device_ms(ctx, "train.forward")
