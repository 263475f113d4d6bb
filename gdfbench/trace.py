"""The reduction of a torch.profiler trace to the numbers the readers need.

The traced run wraps its window in a profiler (CPU and CUDA activities)
and the window itself in the span `gdfbench.window`. The trace, exported
in Chrome's format, holds the host's spans (`user_annotation`), its
operators (`cpu_op`), its CUDA calls (`cuda_runtime`, `cuda_driver`) and
the device's kernels, copies and memsets, each device event tied to the
host call that launched it by its `correlation` id. All times are in
microseconds on one clock.

A device event belongs to the innermost benchmark span open on the host
when its launch was called. A device event whose launch the trace lacks
takes the span of the event before it on its stream.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "gdfbench.window"
PREFIX = "gdfbench."


def export(prof) -> dict:
    """The profiler's trace as a dict (through a file in TMPDIR, removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def _interval(e) -> tuple:
    ts = float(e["ts"])
    return ts, ts + float(e.get("dur", 0.0))


def union(intervals) -> list:
    """The union of [start, end) intervals, merged and sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Intervals:
    """Named intervals sorted by start, for `innermost` lookups."""

    LOOKBACK = 64

    def __init__(self, items):
        self.items = sorted(items, key=lambda s: s[0])
        self.starts = [s[0] for s in self.items]

    def innermost(self, ts: float):
        """The name of the latest-starting interval open at `ts`, among
        the LOOKBACK last to start (nesting is shallower), or None."""
        i = bisect.bisect_right(self.starts, ts)
        for a, b, name in reversed(self.items[max(0, i - self.LOOKBACK):i]):
            if a <= ts < b:
                return name
        return None


class Trace:
    """The events of one traced window."""

    def __init__(self, data: dict):
        events = data["traceEvents"] if isinstance(data, dict) else data
        events = [e for e in events if e.get("ph") == "X"]
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.launch = {e["args"]["correlation"]: e for e in events
                       if e.get("cat") in LAUNCH_CATS
                       and "correlation" in e.get("args", {})}
        self.spans = [e for e in events if e.get("cat") == "user_annotation"
                      and e.get("name", "").startswith(PREFIX)]
        self.host_ops = [e for e in events
                         if e.get("cat") in ("cpu_op",) + LAUNCH_CATS]
        windows = [e for e in self.spans if e["name"] == WINDOW]
        self.window = _interval(windows[0]) if windows else (0.0, 0.0)
        self._owner = None

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> list:
        """The union of every device event's interval, clipped to the
        window."""
        lo, hi = self.window
        return [[max(a, lo), min(b, hi)]
                for a, b in union(_interval(e) for e in self.device)
                if b > lo and a < hi]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def _spans(self, tid=None) -> Intervals:
        return Intervals(_interval(e) + (e["name"],) for e in self.spans
                         if e["name"] != WINDOW
                         and (tid is None or e["tid"] == tid))

    def owners(self) -> list:
        """Each device event's span name (None outside every span)."""
        if self._owner is not None:
            return self._owner
        spans = self._spans()
        owner = []
        for e in self.device:
            launch = self.launch.get(e.get("args", {}).get("correlation"))
            owner.append(None if launch is None else
                         spans.innermost(float(launch["ts"])))
        # a device event whose launch is missing: its stream predecessor's
        last = {}
        order = sorted(range(len(self.device)),
                       key=lambda i: float(self.device[i]["ts"]))
        for i in order:
            e = self.device[i]
            stream = (e.get("args", {}).get("device"),
                      e.get("args", {}).get("stream"))
            if e.get("args", {}).get("correlation") in self.launch:
                last[stream] = owner[i]
            else:
                owner[i] = last.get(stream)
        self._owner = owner
        return owner

    def span_device_s(self, name: str) -> float:
        """Device seconds of the events launched inside spans `name`."""
        lo, hi = self.window
        total = 0.0
        for e, own in zip(self.device, self.owners()):
            if own == name:
                a, b = _interval(e)
                total += max(0.0, min(b, hi) - max(a, lo))
        return total / 1e6

    def top_device_ops(self, k: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        by = defaultdict(float)
        for e in self.device:
            by[e["name"][:120]] += float(e.get("dur", 0.0)) / 1e6
        return [[n, s] for n, s in sorted(by.items(),
                                          key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """[what the host was doing, seconds] of the device's idle time in
        the window, summed by the benchmark span and the innermost host
        operation open on the window's thread at each gap's middle."""
        lo, hi = self.window
        busy = self.busy_intervals()
        gaps, t = [], lo
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        windows = [e for e in self.spans if e["name"] == WINDOW]
        tid = windows[0]["tid"] if windows else None
        spans = self._spans(tid)
        ops = Intervals(_interval(e) + (e["name"],) for e in self.host_ops
                        if tid is None or e["tid"] == tid)
        by = defaultdict(float)
        for a, b in gaps:
            mid = (a + b) / 2
            what = (spans.innermost(mid) or "outside spans").removeprefix(
                PREFIX)
            op = ops.innermost(mid)
            if op is not None:
                what += ":" + op[:60]
            by[what] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(by.items(),
                                          key=lambda x: -x[1])[:k]]
