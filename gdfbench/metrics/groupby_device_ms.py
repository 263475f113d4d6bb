"""groupby_device_ms: device time of the kernels launched inside the
`gdfbench.groupby` spans (ops.groupby: the engine's sorts, H3 scans, H1),
a query, over the traced window."""
from ._span import device_ms_per_query


def read(ctx):
    return device_ms_per_query(ctx, "groupby")
