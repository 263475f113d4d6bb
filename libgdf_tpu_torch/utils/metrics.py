"""Per-operator metrics: rows, estimated bytes moved, host wall time.

Counterpart of `libgdf_tpu/utils/metrics.py`. Recording is off by default.
When on, every instrumented operator appends an event (name, rows in/out,
bytes estimate, host wall seconds). Reading `rows_out`, a device tensor,
syncs the device, so turn recording on only where that cost is wanted.
The wall time is the host's clock around the call: without a sync it times
the enqueue, not the device.
"""
from __future__ import annotations

import contextlib
import csv
import io
import threading
import time
from dataclasses import dataclass, field


@dataclass
class OpEvent:
    name: str
    rows_in: int
    rows_out: int
    bytes_est: int
    wall_s: float


@dataclass
class _Registry:
    enabled: bool = False
    events: list = field(default_factory=list)
    lock: threading.Lock = field(default_factory=threading.Lock)


_REG = _Registry()


def enable(on: bool = True) -> None:
    """Turn per-op event recording on/off (≅ rmmOptions_t.enable_logging)."""
    _REG.enabled = on


def reset() -> None:
    with _REG.lock:
        _REG.events.clear()


def events() -> list:
    with _REG.lock:
        return list(_REG.events)


def write_log() -> str:
    """CSV dump (≅ rmmWriteLog / rmmGetLog, include/memory.h:160-184)."""
    buf = io.StringIO()
    w = csv.writer(buf)
    w.writerow(["op", "rows_in", "rows_out", "bytes_est", "wall_s"])
    for e in events():
        w.writerow([e.name, e.rows_in, e.rows_out, e.bytes_est,
                    round(e.wall_s, 6)])
    return buf.getvalue()


def table_bytes(table) -> int:
    """Logical byte footprint of a Table's buffers (validity counted as a
    packed bitmask)."""
    total = 0
    for c in table.columns:
        total += c.data.element_size() * c.data.shape[0]
        if c.valid is not None:
            total += c.valid.shape[0] // 8 + 1
    return total


@contextlib.contextmanager
def op_metrics(name: str, rows_in: int = 0, bytes_est: int = 0):
    """Record one operator event; yields a dict the op may update with
    `rows_out` (an int or a 0-d tensor)."""
    if not _REG.enabled:
        yield {}
        return
    info = {"rows_out": 0}
    t0 = time.perf_counter()
    try:
        yield info
    finally:
        wall = time.perf_counter() - t0
        ro = int(info.get("rows_out", 0))
        with _REG.lock:
            _REG.events.append(OpEvent(name, int(rows_in), ro,
                                       int(bytes_est), wall))
