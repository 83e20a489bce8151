"""Flash attention's share of its roofline, forward and backward calls
together (`counts/flash.py`)."""
from portbench.roofline import share_pct

UNIT = "%"


def read(ctx):
    return share_pct(ctx, "flash")
