"""The readers of libgdf_tpu_torch's own spans (metrics/_program.py): on a
small synthetic profiler trace on the CPU, and on the card, where every
blocking CUDA call of the plans' library calls has to lie inside a
`libgdf.sync.*` span, one a count of the program's counter."""
import pytest
import torch

from gdfbench import mix as mixes, spec
from gdfbench.data import tpch
from gdfbench.harness import profiler, span_factory
from gdfbench.metrics import _program
from gdfbench.trace import WINDOW, Intervals, Trace, _interval, export

from ._cells import SEED, small_cell
from .test_gdfbench_card import need_cards
from .test_gdfbench_metrics import ctx, ev

BASE = [
    ev("user_annotation", "gdfbench.window", 0, 1000),
    ev("user_annotation", "gdfbench.filter", 100, 200),
    ev("user_annotation", "gdfbench.join", 400, 380),
    ev("user_annotation", "gdfbench.groupby", 800, 195),
    ev("cuda_runtime", "cudaLaunchKernel", 110, 5, correlation=1),
    ev("cuda_runtime", "cudaLaunchKernel", 410, 5, correlation=2),
    ev("cuda_runtime", "cudaLaunchKernel", 810, 5, correlation=3),
    ev("cuda_runtime", "cudaMemsetAsync", 812, 2, correlation=4),
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
]
# The program's spans on the window's thread (1) and on another (2).
# Idle: 0..200 inside filter_table (enqueue), 300..500 outside the library
# (the join starts at 402), 750..850 holds the end of join.total's sync,
# 950..1000 inside groupby (enqueue: the compaction's sync ends there on
# thread 2, not on the window's).
PROGRAM = [
    ev("cpu_op", "libgdf.op.filter_table", 100, 90),
    ev("cpu_op", "libgdf.op.join", 402, 358),
    ev("cpu_op", "libgdf.sort", 405, 10),
    ev("cpu_op", "libgdf.sync.join.total", 720, 40),
    ev("cpu_op", "libgdf.op.groupby", 800, 190),
    ev("cpu_op", "libgdf.sort", 805, 10),
    ev("cpu_op", "libgdf.sync.table.compact", 960, 35, tid=2),
]


def traced(program=True) -> Trace:
    return Trace({"traceEvents": BASE + (PROGRAM if program else [])})


def read(metric, c):
    return spec.reader(metric).read(c)


def test_program_readers():
    t = traced()
    assert read("host_syncs_per_query", ctx(t)) == pytest.approx(1.0)
    assert read("sync_idle_share", ctx(t)) == pytest.approx(10.0)
    assert read("enqueue_idle_share", ctx(t)) == pytest.approx(25.0)
    # 500..700 and its copy (no launch record: the stream predecessor's),
    # 850..900 and the memset 880..950, over 2 queries
    assert read("sort_device_ms", ctx(t)) == pytest.approx(0.185)


def test_idle_split_by_site_and_operator():
    split = _program.idle_split(traced())
    assert split["sync"] == pytest.approx(100e-6)
    assert dict(split["sync_sites"]) == {"join.total": pytest.approx(100e-6)}
    assert split["enqueue"] == pytest.approx(250e-6)
    assert dict(split["enqueue_ops"]) == {
        "filter_table": pytest.approx(200e-6),
        "groupby": pytest.approx(50e-6)}
    assert _program.device_s_inside(traced(), "libgdf.op.join") == \
        pytest.approx(250e-6)


def test_shares_are_parts_of_the_idle_share():
    c = ctx(traced())
    parts = read("sync_idle_share", c) + read("enqueue_idle_share", c)
    assert parts <= read("device_idle_share", c)
    assert read("device_idle_share", c) - parts == pytest.approx(20.0)


def test_accepted_readers_read_the_same_beside_program_spans():
    for m in ("groupby_device_ms", "join_device_ms", "device_idle_share"):
        assert read(m, ctx(traced())) == read(m, ctx(traced(False)))


@pytest.mark.parametrize("metric", ["host_syncs_per_query",
                                    "sync_idle_share", "enqueue_idle_share",
                                    "sort_device_ms"])
def test_nothing_to_read(metric):
    """No trace, or a program without spans (an older commit): None."""
    assert read(metric, ctx()) is None
    assert read(metric, ctx(traced(False))) is None
    empty = Trace({"traceEvents": [
        ev("user_annotation", "gdfbench.window", 0, 1000)]})
    assert read(metric, ctx(empty)) is None


# -- on the card ---------------------------------------------------------------

def blocking(name: str) -> bool:
    """A CUDA call with which the host waits for the device."""
    return "Synchronize" in name or name == "cudaMemcpy"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tpch_sf10.q1", "tpch_sf10.q3"])
def test_every_host_wait_in_a_library_call_is_a_counted_sync(name):
    """A cell's plan at SF 0.1 under the profiler: each blocking CUDA call
    on the window's thread inside a `gdfbench.*` span other than `fetch`
    (the plan's own reads) lies inside a `libgdf.sync.*` span, and the
    program's counter rose by the number of those spans."""
    need_cards(1)
    from libgdf_tpu_torch.utils import tracing
    cell = small_cell(name, 0.1)
    qmod = spec.query(cell["mix"]["query"])
    dev = torch.device("cuda:0")
    state = qmod.prepare(tpch.generate(0.1, SEED, 0, 1, dev), cell["config"])
    params = mixes.stream(cell["mix"], SEED)
    for _ in range(2):
        qmod.run(state, next(params), span_factory(False))
    torch.cuda.synchronize(dev)
    span = span_factory(True)
    tracing.reset_counters()
    with profiler(True, [dev]) as prof:
        with span("window"):
            for _ in range(4):
                qmod.run(state, next(params), span)
    syncs = tracing.counters()["host_sync"]
    trace = Trace(export(prof))
    assert syncs == len(_program.spans(trace, _program.SYNC)) > 0

    tid = _program.window_tid(trace)
    plan = Intervals(_interval(e) + (e["name"],) for e in trace.spans
                     if e["name"] != WINDOW and e["tid"] == tid)
    counted = _program.Cover(_program.spans(trace, _program.SYNC))
    waits = [e for e in trace.host_ops if e["tid"] == tid
             and blocking(e["name"]) and plan.innermost(float(e["ts"]))
             not in (None, "gdfbench.fetch")]
    stray = [(e["name"], plan.innermost(float(e["ts"])), e["ts"])
             for e in waits if not counted.holds(tid, float(e["ts"]))]
    assert waits and not stray, stray
