"""sort_device_ms: device time of the kernels launched inside the
`libgdf.sort` spans (libgdf_tpu_torch's engine.multi_sort: its torch.sort
passes and operand gathers, for every operator's sort), a query, over the
traced window."""
from ._program import SORT, device_s_inside, spans


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace.device or not ctx.get("queries") \
            or not spans(trace, SORT):
        return None
    return device_s_inside(trace, SORT) * 1e3 / ctx["queries"]
