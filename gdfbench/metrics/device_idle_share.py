"""device_idle_share: the share of the traced window in which no kernel,
copy or memset ran on the card, on any stream, in %."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
