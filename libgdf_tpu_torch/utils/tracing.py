"""Tracing: the program's spans on the profiler's clock, and a count of its
host reads.

Counterpart of `libgdf_tpu/utils/tracing.py` (≅ the reference's NVTX
layer: gdf_nvtx_range_push[_hex]/pop, functions.h:18-52, src/
nvtx_utils.cpp:19-76, and the PUSH_RANGE/POP_RANGE macros with their
per-operator colors, src/nvtx_utils.h:17-66).

- `span(name)` is a profiler span while a torch.profiler records the
  calling thread, and a shared no-op context otherwise (one flag check).
  The span is the profiler's fast record function: a host event on the
  clock of the device events, so a kernel belongs to the spans open at its
  launch (launch correlation) and an idle gap of the device to the spans
  open on the host meanwhile. The operators open `libgdf.op.<name>`
  (`spanned`), `engine.multi_sort` opens `libgdf.sort`.
- `host_sync(site)` wraps each place where the host waits on the device
  (a value read to the host, an implicit sync): it counts the read, always,
  and spans it `libgdf.sync.<site>`. `count(event, n)` counts the path an
  operator took (the group-by's `groupby.dense` / `groupby.wide` /
  `groupby.sort`), a call (`reduce`) and the rows it took them with
  (`groupby.sort.rows`, `reduce.rows`). `counters()` reads the counts.
- The ABI's ranges (`range_push` / `range_pop`) are a
  `torch.profiler.record_function` each, and an NVTX range where CUDA is
  available, for tools that read NVTX. Colors are kept as labels.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from collections import Counter

import torch
from torch._C._profiler import _RecordFunctionFast

# ≅ gdf_color (types.h:140-150): named colors kept as labels.
GDF_GREEN = "green"
GDF_BLUE = "blue"
GDF_YELLOW = "yellow"
GDF_PURPLE = "purple"
GDF_CYAN = "cyan"
GDF_RED = "red"
GDF_WHITE = "white"
GDF_DARK_GREEN = "dark_green"
GDF_ORANGE = "orange"

_NO_SPAN = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


def span(name: str):
    """A profiler span `name` while a profiler records this thread, else a
    shared no-op context."""
    return _RecordFunctionFast(name) if _profiling() else _NO_SPAN


def spanned(name: str):
    """Decorator: the function's calls each inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return traced
    return wrap


_sync_lock = threading.Lock()
_syncs: Counter = Counter()
_events: Counter = Counter()


def host_sync(site: str):
    """Count one host wait on the device at `site` and return its span
    `libgdf.sync.<site>`; wrap the statement that waits:

        with host_sync("table.compact"):
            n = int(self.num_rows)

    The count is exact across threads (one lock) and counts reads of CPU
    tensors too, so the path a CPU test runs counts as on the card."""
    with _sync_lock:
        _syncs[site] += 1
    return span("libgdf.sync." + site)


def count(event: str, n: int = 1) -> None:
    """Add `n` to the count of `event`: a path an operator took
    (`groupby.dense`, `groupby.wide`, `groupby.sort`, one each), a call
    (`reduce`) or the rows it took them with (`groupby.sort.rows`,
    `reduce.rows`: the input's capacity), under the lock of the host-sync
    counts."""
    with _sync_lock:
        _events[event] += n


def counters() -> dict:
    """{"host_sync": every count, "host_sync.<site>": each site's, and
    "<event>": each counted event's} since the last `reset_counters()`."""
    with _sync_lock:
        out = {"host_sync": sum(_syncs.values())}
        out.update((f"host_sync.{s}", n) for s, n in sorted(_syncs.items()))
        out.update(sorted(_events.items()))
    return out


def reset_counters() -> None:
    with _sync_lock:
        _syncs.clear()
        _events.clear()


_stack = threading.local()


def _ranges():
    if not hasattr(_stack, "r"):
        _stack.r = []
    return _stack.r


def range_push(name: str, color: str | int = GDF_GREEN) -> None:
    """≅ gdf_nvtx_range_push (src/nvtx_utils.cpp:19-40)."""
    ann = torch.profiler.record_function(str(name))
    ann.__enter__()
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(str(name))
    _ranges().append((ann, nvtx))


def range_push_hex(name: str, color: int = 0) -> None:
    """≅ gdf_nvtx_range_push_hex (src/nvtx_utils.cpp:42-58)."""
    range_push(name, color)


def range_pop() -> None:
    """≅ gdf_nvtx_range_pop (src/nvtx_utils.cpp:60-76); a pop with no open
    range does nothing."""
    r = _ranges()
    if r:
        ann, nvtx = r.pop()
        if nvtx:
            torch.cuda.nvtx.range_pop()
        ann.__exit__(None, None, None)


def op_range(name: str, color: str = GDF_GREEN):
    """Internal PUSH_RANGE/POP_RANGE analogue (src/nvtx_utils.h:36-66):
    `span(name)` around an operator body; the color is a label."""
    return span(name)
