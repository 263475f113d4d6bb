"""enqueue_idle_share: the share of the traced window in which the card sat
idle while the host worked inside the library, in %: the idle gaps with no
host wait whose middle lies inside a `libgdf.op.*` span on the window's
thread (_program.py). A part of device_idle_share, apart from
sync_idle_share."""
from ._program import share


def read(ctx):
    return share(ctx.get("trace"), "enqueue")
