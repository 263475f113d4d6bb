"""libgdf_tpu_torch's tracing on the CPU: the operators' spans exist only
under a profiler and nest by its stack, and the count of host reads is
exact, site by site and across threads."""
import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from libgdf_tpu_torch import Column, GDFDtype, ops
from libgdf_tpu_torch.compat import gdf
from libgdf_tpu_torch.core.bitmask import count_valid
from libgdf_tpu_torch.interop import from_numpy, to_numpy
from libgdf_tpu_torch.ops.kernels import expand_fill
from libgdf_tpu_torch.utils import tracing


def tables(dup_build=False):
    left = from_numpy({"k": np.array([3, 1, 2, 3, 5, 1], np.int32),
                       "v": np.arange(6, dtype=np.float64)}, device="cpu")
    build = [1, 2, 3, 1] if dup_build else [1, 2, 3, 4]
    right = from_numpy({"k2": np.array(build, np.int32),
                        "w": np.arange(4, dtype=np.int64)}, device="cpu")
    return left, right


def run_join(dup_build=False):
    left, right = tables(dup_build)
    return ops.join(left, right, ["k"], ["k2"])


def run_plan():
    """A small filter, expression, join, group-by and order_by, as the
    benchmark's plans chain them; returns the ordered groups."""
    left, right = tables()
    keep = ops.compare_scalar(left["k"], 4, "lt")
    f = ops.filter_table(left, keep)
    f = f.with_column(ops.mul(f["v"], ops.add(f["v"], f["v"]))
                      .with_name("x"))
    j = ops.join(f, right, ["k"], ["k2"]).compact()
    g = ops.groupby(j, ["k"], [("x", "sum", "sx")]).compact()
    return g.gather(ops.order_by(g, ["k"]))


def events(prof) -> list:
    """(name, start, end, thread) of every host event of a profile."""
    return [(e.name, e.time_range.start, e.time_range.end, e.thread)
            for e in prof.events()]


def inside(evs, outer: str, inner_prefix: str) -> list:
    """Names of the events starting with `inner_prefix` that lie inside
    another event, named `outer`, on its thread."""
    outs = [e for e in evs if e[0] == outer]
    return sorted(e[0] for e in evs if e[0].startswith(inner_prefix)
                  and any(o is not e and o[3] == e[3] and o[1] <= e[1]
                          and e[2] <= o[2] for o in outs))


# -- spans ------------------------------------------------------------------

def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a record function entered with no profiler")
    monkeypatch.setattr(tracing, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("libgdf.op.x") is tracing.span("libgdf.sort")
    with tracing.op_range("LIBGDF_JOIN", tracing.GDF_BLUE):
        out = run_plan()
    assert out.capacity > 0
    to_numpy(out)


def test_join_spans_nest_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_join()
    evs = events(prof)
    assert inside(evs, "libgdf.op.join", "libgdf.") == [
        "libgdf.op.join_indices", "libgdf.sort",
        "libgdf.sync.join.key_change", "libgdf.sync.join.total",
        "libgdf.sync.join.unique_build"]
    assert inside(evs, "libgdf.op.join_indices", "libgdf.sync.") == [
        "libgdf.sync.join.key_change", "libgdf.sync.join.total",
        "libgdf.sync.join.unique_build"]
    # the sorts hold torch.sort passes and the operand gathers
    assert inside(evs, "libgdf.sort", "aten::sort")
    assert inside(evs, "libgdf.sort", "aten::index")


@pytest.mark.parametrize("outer,inner", [
    ("libgdf.op.compare_scalar", "aten::le"),
    ("libgdf.op.compare_scalar", "aten::lt"),
    ("libgdf.op.filter_table", "aten::index"),
    ("libgdf.op.add", "aten::add"),
    ("libgdf.op.mul", "aten::mul"),
    ("libgdf.op.groupby", "libgdf.sort"),
    ("libgdf.op.order_by", "libgdf.sort"),
    ("libgdf.op.gather", "aten::index"),
])
def test_operator_spans(outer, inner):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        left, _ = tables()
        ops.compare_scalar(left["k"], 2, "le")
        run_plan()
    assert inside(events(prof), outer, inner)


def test_sync_spans_match_the_counter():
    tracing.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        to_numpy(run_plan())
    syncs = [e[0] for e in events(prof) if e[0].startswith("libgdf.sync.")]
    c = tracing.counters()
    assert len(syncs) == c["host_sync"] > 0
    for site in {s.removeprefix("libgdf.sync.") for s in syncs}:
        assert syncs.count("libgdf.sync." + site) == c[f"host_sync.{site}"]


def test_abi_ranges_stay_user_annotations(tmp_path):
    """The ABI's ranges are user annotations; the program's spans are the
    profiler's host operations (category `cpu_op` in the exported trace),
    on the same clock, nested inside them."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gdf.gdf_nvtx_range_push("LIBGDF_TEST_RANGE", "green")
        with tracing.span("libgdf.op.inner"):
            pass
        gdf.gdf_nvtx_range_pop()
    assert inside(events(prof), "LIBGDF_TEST_RANGE", "libgdf.") == [
        "libgdf.op.inner"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    cats = {e["name"]: e.get("cat")
            for e in json.loads(path.read_text())["traceEvents"]}
    assert cats["LIBGDF_TEST_RANGE"] == "user_annotation"
    assert cats["libgdf.op.inner"] == "cpu_op"


# -- the count of host reads --------------------------------------------------

def _stencil():
    col = Column.from_array(np.array([1, 2, 3, 4], np.int32), device="cpu")
    st = Column.from_array(np.array([1, 0, 1, 0], np.int8), device="cpu")
    return gdf.gpu_apply_stencil(col, st)


JOIN = {"join.key_change": 1, "join.total": 1, "join.unique_build": 1}


@pytest.mark.parametrize("fn,want", [
    (run_join, JOIN),
    (lambda: run_join(dup_build=True), JOIN),
    (lambda: run_join().compact(), {**JOIN, "table.compact": 1}),
    (lambda: ops.groupby(tables()[0], ["k"], [("v", "sum")]),
     {"groupby.new_group": 1}),
    (lambda: ops.filter_table(tables()[0], ops.compare_scalar(
        tables()[0]["v"], 2.5, "lt")), {}),
    (lambda: to_numpy(ops.filter_table(tables()[0], ops.compare_scalar(
        tables()[0]["k"], 3, "eq"))),
     {"table.compact": 1, "interop.to_numpy": 1}),
    (lambda: tables()[0]["v"].to_numpy_masked(), {"column.to_numpy": 1}),
    (lambda: expand_fill(torch.tensor([0, 2], dtype=torch.int32),
                         [torch.tensor([5, 6], dtype=torch.int32)],
                         torch.tensor(4)), {"expand.cap": 1}),
    (lambda: expand_fill(torch.tensor([0, 2], dtype=torch.int32),
                         [torch.tensor([5, 6], dtype=torch.int32)], 4), {}),
    (lambda: ops.partition_sizes(torch.tensor([0, 1, 1, 3]), 3),
     {"hash.partition_sizes": 1}),
    (_stencil, {"stencil.count": 1}),
    (lambda: ops.cast(tables()[0]["v"], GDFDtype.INT32),
     {"convert.bounds": 1}),
    (lambda: tables()[0].with_num_rows(3), {"table.count": 1}),
    (lambda: tables()[0].with_num_rows(torch.tensor(3)), {}),
    (lambda: count_valid(None, 4), {"bitmask.count": 1}),
    (lambda: ops.window_function(tables()[0], "v", "sum", preceding=2),
     {"window.seg_start": 1}),
    (lambda: ops.window_function(tables()[0], "v", "sum", order_by=["v"],
                                 preceding=2.0, frame="range"),
     {"window.seg_start": 1, "window.preceding": 1}),
], ids=["join", "join_general_path", "join_compact", "groupby", "filter",
        "filter_to_numpy", "column_to_numpy", "expand_tensor_cap",
        "expand_int_cap", "partition_sizes", "apply_stencil", "cast",
        "table_count", "table_count_tensor", "count_valid", "window_rows",
        "window_range"])
def test_counter_counts_each_read_once(fn, want):
    tracing.reset_counters()
    fn()
    got = tracing.counters()
    assert got == {"host_sync": sum(want.values()),
                   **{f"host_sync.{k}": v for k, v in want.items()}}
    fn()
    assert tracing.counters()["host_sync"] == 2 * sum(want.values())
    tracing.reset_counters()
    assert tracing.counters() == {"host_sync": 0}


def test_counter_is_exact_across_threads():
    threads_n, joins = 12, 20
    tracing.reset_counters()
    errors = []

    def work():
        try:
            for _ in range(joins):
                run_join()
        except Exception as e:           # reported below, with the count
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(threads_n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    n = threads_n * joins
    assert tracing.counters() == {
        "host_sync": len(JOIN) * n,
        **{f"host_sync.{site}": n for site in JOIN}}
