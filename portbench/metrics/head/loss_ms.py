"""The loss head's device time a profiled step: the program's ``lm.head``
span (the last layer's output through the final norm, the unembedding
and the softcap to the cross entropy) and its backward ``lm.head.bwd``."""
from portbench.spans import device_ms

UNIT = "ms"


def read(ctx):
    return device_ms(ctx, "lm.head", "lm.head.bwd")
