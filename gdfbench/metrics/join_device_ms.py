"""join_device_ms: device time of the kernels launched inside the
`gdfbench.join` spans (ops.join: the merge sort, scans, H1 / H4, the
gathers of the output), a query, over the traced window."""
from ._span import device_ms_per_query


def read(ctx):
    return device_ms_per_query(ctx, "join")
