"""The trace reduction and each per-layer reader on a small synthetic
profiler trace (Chrome format, microseconds)."""
import pytest

from gdfbench import roofline, spec
from gdfbench.trace import Trace, union


def ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def synthetic() -> Trace:
    """A 1000 us window: a filter span (launch at 110 -> kernel 200..300),
    a join span (launch 410 -> 500..700, and a copy with no launch record
    right after it on the same stream, 700..750), a groupby span (launch
    810 -> 850..900, overlapping a memset on another stream 880..950)."""
    return Trace({"traceEvents": [
        ev("user_annotation", "gdfbench.window", 0, 1000),
        ev("user_annotation", "gdfbench.filter", 100, 200),
        ev("user_annotation", "gdfbench.join", 400, 300),
        ev("user_annotation", "gdfbench.groupby", 800, 150),
        ev("cpu_op", "aten::nonzero", 395, 200),
        ev("cuda_runtime", "cudaLaunchKernel", 110, 5, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 410, 5, correlation=2),
        ev("cuda_runtime", "cudaLaunchKernel", 810, 5, correlation=3),
        ev("cuda_runtime", "cudaMemsetAsync", 812, 5, correlation=4),
        ev("kernel", "compact_lookback", 200, 100, tid=7, correlation=1,
           device=0, stream=7),
        ev("kernel", "radix_sort", 500, 200, tid=7, correlation=2,
           device=0, stream=7),
        ev("gpu_memcpy", "Memcpy DtoH", 700, 50, tid=7, correlation=99,
           device=0, stream=7),
        ev("kernel", "seg_scan", 850, 50, tid=7, correlation=3,
           device=0, stream=7),
        ev("gpu_memset", "Memset", 880, 70, tid=8, correlation=4,
           device=0, stream=8),
    ]})


def test_union_and_busy():
    assert union([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]
    t = synthetic()
    assert t.window_s == pytest.approx(1e-3)
    # 200..300, 500..750, 850..950
    assert t.busy_s() == pytest.approx(450e-6)


def test_span_attribution():
    t = synthetic()
    assert t.span_device_s("gdfbench.filter") == pytest.approx(100e-6)
    # the copy without a launch record takes its stream predecessor's span
    assert t.span_device_s("gdfbench.join") == pytest.approx(250e-6)
    assert t.span_device_s("gdfbench.groupby") == pytest.approx(120e-6)


def test_breakdown():
    t = synthetic()
    ops = t.top_device_ops()
    assert ops[0] == ["radix_sort", pytest.approx(200e-6)]
    gaps = dict(t.idle_gaps())
    # idle: 0..200 (filter from 100), 300..500 (outside, join from 400),
    # 750..850, 950..1000
    assert sum(gaps.values()) == pytest.approx(550e-6)
    assert any(k.startswith("join:aten::nonzero") for k in gaps)


def ctx(trace=None, **kw):
    base = {"trace": trace, "queries": 2, "filter_bytes": 0,
            "window_s": 1e-3, "exchange_s": None, "local_shards": 1}
    base.update(kw)
    return base


def test_readers():
    t = synthetic()
    read = lambda m, c: spec.reader(m).read(c)  # noqa: E731
    assert read("groupby_device_ms", ctx(t)) == pytest.approx(0.06)
    assert read("join_device_ms", ctx(t)) == pytest.approx(0.125)
    nbytes = int(roofline.HBM_BYTES_PER_S * 50e-6)
    assert read("filter_roofline", ctx(t, filter_bytes=nbytes)) == \
        pytest.approx(50.0)
    assert read("device_idle_share", ctx(t)) == pytest.approx(55.0)
    assert read("exchange_share", ctx(t, exchange_s=4e-4,
                                      local_shards=2)) == pytest.approx(20.0)


def test_readers_find_nothing_to_read():
    """No trace, no device events, no mesh: every reader returns None,
    never a 0 for a share of a roofline."""
    empty = Trace({"traceEvents": [
        ev("user_annotation", "gdfbench.window", 0, 1000)]})
    for m in ("groupby_device_ms", "join_device_ms", "filter_roofline",
              "device_idle_share", "exchange_share"):
        assert spec.reader(m).read(ctx()) is None
        assert spec.reader(m).read(ctx(empty, filter_bytes=10)) is None


def test_filter_bytes():
    assert roofline.filter_bytes(10, [4, 8, 8], 3, [8, 8]) == 10 * 20 + 3 * 16
    assert roofline.bound_seconds(3.35e12) == pytest.approx(1.0)
