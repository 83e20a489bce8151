"""The grouped matmul's share of its roofline (`counts/gmm.py`)."""
from portbench.roofline import share_pct

UNIT = "%"


def read(ctx):
    return share_pct(ctx, "gmm")
