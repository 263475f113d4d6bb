"""exchange_share: the share of the window that the mesh's shards spent in
collectives, in % (the program's own counter, `mesh.exchange.seconds`,
over local shards and the window)."""


def read(ctx):
    if ctx.get("exchange_s") is None or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["exchange_s"] / ctx["local_shards"] / ctx["window_s"]
