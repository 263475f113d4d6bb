"""host_syncs_per_query: the host's waits on the device inside the library,
a query: the `libgdf.sync.<site>` spans of libgdf_tpu_torch (one a count
of its `host_sync` counter) that start in the traced window, over its
queries."""
from ._program import SYNC, spans


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not ctx.get("queries") or not spans(trace):
        return None
    return len(spans(trace, SYNC)) / ctx["queries"]
