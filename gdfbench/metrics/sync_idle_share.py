"""sync_idle_share: the share of the traced window in which the card sat
idle through a host wait inside the library, in %: the idle gaps that hold
the end of a `libgdf.sync.*` span on the window's thread (_program.py).
A part of device_idle_share."""
from ._program import share


def read(ctx):
    return share(ctx.get("trace"), "sync")
