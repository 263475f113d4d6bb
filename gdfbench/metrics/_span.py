"""Device milliseconds a query inside one benchmark span."""
from __future__ import annotations


def device_ms_per_query(ctx: dict, span: str):
    trace = ctx.get("trace")
    if trace is None or not trace.device or not ctx.get("queries"):
        return None
    secs = trace.span_device_s(f"gdfbench.{span}")
    return secs * 1e3 / ctx["queries"] if secs > 0 else None
