"""The SSD scan's share of its roofline, forward and backward calls
together (`counts/ssd_scan.py`)."""
from portbench.roofline import share_pct

UNIT = "%"


def read(ctx):
    return share_pct(ctx, "ssd_scan")
