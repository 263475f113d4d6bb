"""groupby_scan_device_ms: device time of the kernels launched inside the
`libgdf.groupby.sort.scan` spans (libgdf_tpu_torch's sort-path group-by:
every aggregate's segmented scans, H3), a query, over the traced window.
None where the program opens no such span (a group-by on the dense path,
or an older commit)."""
from ._program import device_s_inside, spans

SPAN = "libgdf.groupby.sort.scan"


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace.device or not ctx.get("queries") \
            or not spans(trace, SPAN):
        return None
    return device_s_inside(trace, SPAN) * 1e3 / ctx["queries"]
