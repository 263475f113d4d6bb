"""filter_roofline: the filters' share of their memory roofline, in %.

The bound is the filters' logical bytes (roofline.filter_bytes: each
column read once, each kept row written once, from shapes and the counted
kept rows) over the card's peak rate; the time is the device time of the
kernels launched inside the `gdfbench.filter` spans (compare_scalar and
filter_table, H1)."""
from ..roofline import bound_seconds


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    secs = trace.span_device_s("gdfbench.filter")
    nbytes = ctx.get("filter_bytes", 0)
    if secs <= 0 or nbytes <= 0:
        return None
    return 100.0 * bound_seconds(nbytes) / secs
