"""The host's time to issue one step: the host time inside the program's
``train.step`` span less the time it waits for the card there
(``train.sync``), a profiled step.  The profiler stretches it: it reads
the host's speed, not an unprofiled step's time."""
from portbench.spans import host_ms

UNIT = "ms"


def read(ctx):
    step = host_ms(ctx, "train.step")
    if step is None:
        return None
    return step - (host_ms(ctx, "train.sync") or 0.0)
