"""reduce_device_ms: device time of the kernels launched inside the
`libgdf.op.reduce` spans (libgdf_tpu_torch's ops.reduce: the flush, the
mask of NULL and dead rows and torch's reduction), a query, over the
traced window. None on a program without the span (an older commit)."""
from ._program import OP, device_s_inside, spans

REDUCE = OP + "reduce"


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace.device or not ctx.get("queries") \
            or not spans(trace, REDUCE):
        return None
    return device_s_inside(trace, REDUCE) * 1e3 / ctx["queries"]
