"""The program's own spans in a traced window, for the readers that read
them.

libgdf_tpu_torch opens `libgdf.op.<operator>` at each operator,
`libgdf.sort` around `engine.multi_sort` and `libgdf.sync.<site>` around
each host wait on the device (`libgdf_tpu_torch/utils/tracing.py`). The
profiler records them as host operations, so `Trace.host_ops` holds them
beside aten's, on the clock of the device events. A program without them
(an older commit) gives no spans, and the readers then return None.

A device event is inside a span when the call that launched it (launch
correlation) ran inside the span on its thread; a device event whose
launch the trace lacks takes its stream predecessor's verdict, as
`Trace.owners` does. The idle gaps are the window's stretches with no
device event on any stream (`Trace.busy_intervals`), split on the
window's thread:

- sync idle: each gap that holds the end of a `libgdf.sync.*` span: the
  device drained while the host waited, and stayed idle until the next
  launch landed;
- enqueue idle: each other gap whose middle lies inside a `libgdf.op.*`
  span: the host inside the library, slower than the card;
- the rest: idle in the plan and the harness, outside the library.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

from ..trace import WINDOW, Intervals, _interval, union

PREFIX = "libgdf."
OP = "libgdf.op."
SORT = "libgdf.sort"
SYNC = "libgdf.sync."


def spans(trace, prefix: str = PREFIX) -> list:
    """The program's span events that start in the window."""
    lo, hi = trace.window
    return [e for e in trace.host_ops if e["name"].startswith(prefix)
            and lo <= float(e["ts"]) < hi]


def window_tid(trace):
    windows = [e for e in trace.spans if e["name"] == WINDOW]
    return windows[0]["tid"] if windows else None


class Cover:
    """The union of some spans' intervals, thread by thread."""

    def __init__(self, events):
        by = defaultdict(list)
        for e in events:
            by[e["tid"]].append(_interval(e))
        self.runs = {tid: union(iv) for tid, iv in by.items()}
        self.starts = {tid: [a for a, _ in r] for tid, r in self.runs.items()}

    def holds(self, tid, ts: float) -> bool:
        runs = self.runs.get(tid)
        if not runs:
            return False
        i = bisect.bisect_right(self.starts[tid], ts) - 1
        return i >= 0 and ts < runs[i][1]


def device_s_inside(trace, prefix: str) -> float:
    """Device seconds in the window of the events launched inside a span
    whose name starts with `prefix`."""
    cover = Cover(spans(trace, prefix))
    lo, hi = trace.window
    last, total = {}, 0.0
    for e in sorted(trace.device, key=lambda e: float(e["ts"])):
        args = e.get("args", {})
        stream = (args.get("device"), args.get("stream"))
        launch = trace.launch.get(args.get("correlation"))
        if launch is None:
            hit = last.get(stream, False)
        else:
            hit = cover.holds(launch["tid"], float(launch["ts"]))
            last[stream] = hit
        if hit:
            a, b = _interval(e)
            total += max(0.0, min(b, hi) - max(a, lo))
    return total / 1e6


def gaps(trace) -> list:
    """The window's idle gaps, (start, end) in microseconds."""
    lo, hi = trace.window
    out, t = [], lo
    for a, b in trace.busy_intervals():
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def idle_split(trace) -> dict:
    """Seconds of the window's idle time: `sync` and `enqueue` (as the
    module says), `sync_sites` (the sync idle by the site of the last sync
    span to end in the gap) and `enqueue_ops` (the enqueue idle by the
    innermost operator span at the gap's middle)."""
    tid = window_tid(trace)
    mine = [e for e in spans(trace) if tid is None or e["tid"] == tid]
    ends = sorted((_interval(e)[1], e["name"]) for e in mine
                  if e["name"].startswith(SYNC))
    end_ts = [t for t, _ in ends]
    ops = Intervals(_interval(e) + (e["name"],) for e in mine
                    if e["name"].startswith(OP))
    cover = Cover([e for e in mine if e["name"].startswith(OP)])
    out = {"sync": 0.0, "enqueue": 0.0, "sync_sites": defaultdict(float),
           "enqueue_ops": defaultdict(float)}
    for a, b in gaps(trace):
        s = (b - a) / 1e6
        i = bisect.bisect_right(end_ts, b) - 1
        if i >= 0 and end_ts[i] >= a:
            out["sync"] += s
            out["sync_sites"][ends[i][1].removeprefix(SYNC)] += s
            continue
        mid = (a + b) / 2
        if cover.holds(tid, mid):
            out["enqueue"] += s
            out["enqueue_ops"][(ops.innermost(mid) or "").removeprefix(
                OP)] += s
    return out


def share(trace, kind: str):
    """`kind` idle ("sync" or "enqueue") over the window, in %, or None
    without device events or program spans."""
    if trace is None or trace.window_s <= 0 or not trace.device \
            or not spans(trace):
        return None
    return 100.0 * idle_split(trace)[kind] / trace.window_s
