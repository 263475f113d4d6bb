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
    """A unique build side takes the hash path: its one read and the sort
    of the matched pairs lie inside `libgdf.join.hash`."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_join()
    evs = events(prof)
    assert inside(evs, "libgdf.op.join", "libgdf.") == [
        "libgdf.join.hash", "libgdf.op.join_indices", "libgdf.sort",
        "libgdf.sync.join.hash.count"]
    assert inside(evs, "libgdf.op.join_indices", "libgdf.") == [
        "libgdf.join.hash", "libgdf.sort", "libgdf.sync.join.hash.count"]
    assert inside(evs, "libgdf.join.hash", "libgdf.") == [
        "libgdf.sort", "libgdf.sync.join.hash.count"]
    # the sorts hold torch.sort passes and the operand gathers
    assert inside(evs, "libgdf.sort", "aten::sort")
    assert inside(evs, "libgdf.sort", "aten::index")


def test_join_fallback_spans_nest_under_a_profiler():
    """A duplicate build key: the hash path's read inside
    `libgdf.join.hash`, then the sort path's three inside
    `libgdf.join.sort`, both inside `libgdf.op.join_indices`."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_join(dup_build=True)
    evs = events(prof)
    assert inside(evs, "libgdf.op.join_indices", "libgdf.join.") == [
        "libgdf.join.hash", "libgdf.join.sort"]
    assert inside(evs, "libgdf.join.hash", "libgdf.sync.") == [
        "libgdf.sync.join.hash.count"]
    # the general path sorts both sides, then the build side alone
    assert inside(evs, "libgdf.join.sort", "libgdf.") == [
        "libgdf.sort", "libgdf.sort", "libgdf.sync.join.key_change",
        "libgdf.sync.join.total", "libgdf.sync.join.unique_build"]


@pytest.mark.parametrize("outer,inner", [
    ("libgdf.op.compare_scalar", "aten::le"),
    ("libgdf.op.compare_scalar", "aten::lt"),
    ("libgdf.op.filter_table", "aten::index"),
    ("libgdf.op.add", "aten::add"),
    ("libgdf.op.mul", "aten::mul"),
    ("libgdf.op.groupby", "libgdf.sort"),
    ("libgdf.op.join_indices", "libgdf.join.hash"),
    ("libgdf.join.hash", "libgdf.sort"),
    ("libgdf.op.groupby", "libgdf.groupby.dense"),
    ("libgdf.op.groupby", "libgdf.groupby.sort"),
    ("libgdf.groupby.sort", "libgdf.sort"),
    ("libgdf.op.order_by", "libgdf.sort"),
    ("libgdf.op.gather", "aten::index"),
    ("libgdf.op.reduce", "aten::sum"),
    ("libgdf.op.reduce", "aten::where"),
])
def test_operator_spans(outer, inner):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        left, _ = tables()
        ops.compare_scalar(left["k"], 2, "le")
        run_plan()
        ops.groupby(left, ["k"], [("v", "min")])     # the sort path
        ops.sum(left["v"], num_rows=torch.tensor(4, dtype=torch.int32))
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


JOIN = {"join.hash.count": 1, "join.hash": 1}
JOIN_FALLBACK = {"join.hash.count": 1, "join.key_change": 1, "join.total": 1,
                 "join.unique_build": 1, "join.hash_fallback": 1,
                 "join.sort": 1}
PATHS = ("groupby.dense", "groupby.sort", "join.hash", "join.sort",
         "join.hash_fallback", "reduce", "reduce.rows", "elementwise.h8",
         "elementwise.torch")  # events, not syncs


@pytest.mark.parametrize("fn,want", [
    (run_join, JOIN),
    (lambda: run_join(dup_build=True), JOIN_FALLBACK),
    (lambda: run_join().compact(), {**JOIN, "table.compact": 1}),
    (lambda: ops.groupby(tables()[0], ["k"], [("v", "sum")]),
     {"groupby.domain": 1, "groupby.dense": 1}),
    (lambda: ops.filter_table(tables()[0], ops.compare_scalar(
        tables()[0]["v"], 2.5, "lt")), {"elementwise.h8": 1}),
    (lambda: to_numpy(ops.filter_table(tables()[0], ops.compare_scalar(
        tables()[0]["k"], 3, "eq"))),
     {"table.compact": 1, "interop.to_numpy": 1, "elementwise.h8": 1}),
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
    (lambda: ops.max(tables()[0]["v"], num_rows=torch.tensor(2)),
     {"reduce": 1, "reduce.rows": 6}),
    (lambda: ops.sum(tables()[0]["k"]), {"reduce": 1, "reduce.rows": 6}),
], ids=["join", "join_general_path", "join_compact", "groupby", "filter",
        "filter_to_numpy", "column_to_numpy", "expand_tensor_cap",
        "expand_int_cap", "partition_sizes", "apply_stencil", "cast",
        "table_count", "table_count_tensor", "count_valid", "window_rows",
        "window_range", "reduce_live", "reduce"])
def test_counter_counts_each_read_once(fn, want):
    syncs = {k: v for k, v in want.items() if k not in PATHS}
    tracing.reset_counters()
    fn()
    got = tracing.counters()
    assert got == {"host_sync": sum(syncs.values()),
                   **{f"host_sync.{k}": v for k, v in syncs.items()},
                   **{k: v for k, v in want.items() if k in PATHS}}
    fn()
    assert tracing.counters()["host_sync"] == 2 * sum(syncs.values())
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
        "host_sync": n, "host_sync.join.hash.count": n, "join.hash": n}


# -- the group-by's three paths ------------------------------------------------

def run_query(name: str) -> dict:
    """One query of a benchmark cell's plan (gdfbench/queries) on a small
    CPU table; the counters it moved."""
    from gdfbench import mix, spec
    from gdfbench.data import tpch
    from gdfbench.harness import span_factory
    cell = spec.cell(spec.load_benchmark(), name)
    cell["config"]["scale_factor"] = 0.002
    qmod = spec.query(cell["mix"]["query"])
    state = qmod.prepare(tpch.generate(0.002, 7, 0, 1, "cpu"),
                         cell["config"])
    params = next(mix.stream(cell["mix"], 7))
    tracing.reset_counters()
    qmod.run(state, params, span_factory(False))
    return tracing.counters()


@pytest.mark.parametrize("name,paths,syncs", [
    ("tpch_sf10.q1", {"groupby.dense": 1}, 2),
    ("tpch_sf10.q3", {"groupby.sort": 1}, 9),
    ("tpch_sf10_q18.q18", {"groupby.wide": 1, "groupby.sort": 1}, 10)])
def test_benchmark_plans_take_their_groupby_path(name, paths, syncs):
    """Q1's keys (two int8 codes, 6 slots) take the dense path, Q3's
    (order keys, dates) the sort path, Q18's subquery (order keys, about
    one slot a line item) the wide path and its outer group-by (a float64
    key among its four) the sort path; the probed group-by waits once, on
    the probe's read, and the plans keep their host waits (2, 9 since Q3's
    joins take the hash path, and 10)."""
    got = run_query(name)
    for path in ("groupby.dense", "groupby.wide", "groupby.sort"):
        assert got.get(path, 0) == paths.get(path, 0), (path, got)
    assert got["host_sync.groupby.domain"] == 1
    assert "host_sync.groupby.new_group" not in got
    assert got["host_sync"] == syncs


@pytest.mark.parametrize("name,calls", [
    ("tpch_sf10.q1", 5), ("tpch_sf10.q3", 5), ("tpch_sf10_q18.q18", 1),
    ("tpch_sf10.q6", 6)])
def test_benchmark_plans_take_h8(name, calls):
    """Every compare_scalar and float add / sub / mul of the plans takes
    H8 (Q1: its filter and two expressions; Q3: three filters and its
    revenue; Q18: the HAVING; Q6: five predicates and the product) and
    none is left on torch."""
    got = run_query(name)
    assert got.get("elementwise.h8") == calls, got
    assert "elementwise.torch" not in got, got


def test_q6_plan_sums_on_the_card_without_a_wait():
    """Q6's plan filters, multiplies and sums the live rows by the
    filter's device count: no host wait in the library, one reduction a
    query over the filter's capacity (every line item), and no group-by
    or join."""
    from gdfbench.data import tpch
    got = run_query("tpch_sf10.q6")
    lines = tpch.generate(0.002, 7, 0, 1, "cpu")["lineitem"]["l_shipdate"]
    assert got["host_sync"] == 0
    assert got["reduce"] == 1
    assert got["reduce.rows"] == lines.shape[0]
    assert not {k for k in got if k.startswith(("groupby.", "join."))}


@pytest.mark.parametrize("name,joins,syncs", [
    ("tpch_sf10.q3", 2, 9), ("tpch_sf10_q18.q18", 3, 10)])
def test_benchmark_joins_take_the_hash_path(name, joins, syncs):
    """Every join of Q3 and Q18 has a unique build side (primary keys, a
    group-by's keys) and takes the hash path, one read each; none sorts."""
    got = run_query(name)
    assert got["join.hash"] == got["host_sync.join.hash.count"] == joins
    assert not {k for k in got if k.startswith(("join.sort",
                                                "join.hash_fallback",
                                                "host_sync.join.total"))}
    assert got["host_sync"] == syncs


def _key_table(float_key=False, null_key=False, wide=False):
    k = np.array([3, 1, 2, 3, 2, 1], np.float32 if float_key else np.int32)
    if wide:
        k *= 5          # 11 slots: 132 bytes of H7's, 240 of the sort's
    nulls = {"k": np.array([0, 0, 1, 0, 0, 0], bool)} if null_key else None
    return from_numpy({"k": k, "v": np.arange(6, dtype=np.float64)}, nulls,
                      device="cpu")


PATH_SPANS = {"groupby.dense": ["libgdf.groupby.dense"],
              "groupby.wide": ["libgdf.groupby.wide"],
              "groupby.sort": ["libgdf.groupby.sort",
                               "libgdf.groupby.sort.extract",
                               "libgdf.groupby.sort.scan"]}


@pytest.mark.parametrize("table,aggs,dropna,path,syncs", [
    (_key_table, [("v", "sum")], True, "groupby.dense", 1),
    (lambda: _key_table(null_key=True), [("v", "sum")], True,
     "groupby.dense", 1),
    (lambda: _key_table(null_key=True), [("v", "sum")], False,
     "groupby.sort", 0),
    (lambda: _key_table(float_key=True), [("v", "sum")], True,
     "groupby.sort", 0),
    (_key_table, [("v", "min")], True, "groupby.sort", 0),
    (_key_table, [("v", "sum"), ("v", "max")], True, "groupby.sort", 0),
    (lambda: _key_table(wide=True), [("v", "sum"), ("v", "avg")], True,
     "groupby.wide", 1),
], ids=["dense", "null_key_dropped", "null_key_kept", "float_key", "min",
        "sum_and_max", "wide"])
def test_groupby_path_follows_the_input(table, aggs, dropna, path, syncs):
    """A key nullable under dropna=False, a float key and a min / max force
    the sort path without a probe (no host wait); the dense and the wide
    path read the probe once. All give the same groups."""
    t = table()
    tracing.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = ops.groupby(t, ["k"], aggs, dropna=dropna)
    got = tracing.counters()
    assert got[path] == 1 and got["host_sync"] == syncs
    assert sorted(set(inside(events(prof), "libgdf.op.groupby",
                             "libgdf.groupby."))) == PATH_SPANS[path]
    ref = ops.groupby(t, ["k"], [("v", "min")] + list(aggs), dropna=dropna)
    want, got_rows = to_numpy(ref), to_numpy(out)
    for name, values in got_rows[0].items():
        np.testing.assert_array_equal(values, want[0][name])


# -- the sort path's phases ------------------------------------------------

def _spans_of(prof, name: str) -> list:
    return [e for e in events(prof) if e[0] == name]


@pytest.mark.parametrize("aggs", [
    [("v", "min")], [("v", "sum"), ("v", "max"), ("v", "count")],
    [("v", "sum"), ("v", "count"), ("v", "avg"), ("v", "min")]],
    ids=["min", "three_aggregates", "deferred_avg"])
def test_sort_path_splits_into_scan_and_extract(aggs):
    """After its sort, the sort path's work lies in one scan span (every
    aggregate's segmented scans) between two extract spans (the
    boundaries and key decode, then the compaction), all inside
    `libgdf.groupby.sort` and none overlapping the sort."""
    t = _key_table()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ops.groupby(t, ["k"], aggs)
    evs = events(prof)
    scan = _spans_of(prof, "libgdf.groupby.sort.scan")
    extract = _spans_of(prof, "libgdf.groupby.sort.extract")
    sort = _spans_of(prof, "libgdf.sort")
    assert len(scan) == 1 and len(extract) == 2 and len(sort) == 1
    first, second = sorted(extract, key=lambda e: e[1])
    assert sort[0][2] <= first[1] and first[2] <= scan[0][1]
    assert scan[0][2] <= second[1]
    assert inside(evs, "libgdf.groupby.sort", "libgdf.groupby.sort.") == [
        "libgdf.groupby.sort.extract", "libgdf.groupby.sort.extract",
        "libgdf.groupby.sort.scan"]
    assert inside(evs, "libgdf.groupby.sort.scan", "aten::")
    assert inside(evs, "libgdf.groupby.sort.extract", "aten::")


def test_dense_path_opens_no_sort_phase():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ops.groupby(_key_table(), ["k"], [("v", "sum")])
    names = {e[0] for e in events(prof)}
    assert "libgdf.groupby.dense" in names
    assert not {n for n in names if n.startswith("libgdf.groupby.sort")}


def test_sort_rows_counts_each_sort_path_input_capacity():
    """`groupby.sort.rows` adds the sort path's input capacity (dead rows
    included: the host knows it without a read); the dense path adds
    nothing."""
    tracing.reset_counters()
    ops.groupby(_key_table(), ["k"], [("v", "sum")])          # dense
    assert "groupby.sort.rows" not in tracing.counters()
    ops.groupby(_key_table(), ["k"], [("v", "min")])          # 6 rows
    wide = from_numpy({"k": np.arange(40, dtype=np.int32) * 7,
                       "v": np.ones(40)}, device="cpu").with_num_rows(
        torch.tensor(25))
    ops.groupby(wide, ["k"], [("v", "sum")])                  # 40 slots
    got = tracing.counters()
    assert got["groupby.sort.rows"] == 6 + 40
    assert got["groupby.sort"] == 2 and got["groupby.dense"] == 1
    tracing.reset_counters()
    assert "groupby.sort.rows" not in tracing.counters()


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def _trace(program: bool):
    """A 1000 us window with one kernel launched inside a scan span and
    one inside an extract span (when `program`), 2 queries."""
    from gdfbench.trace import Trace
    evs = [
        _ev("user_annotation", "gdfbench.window", 0, 1000),
        _ev("user_annotation", "gdfbench.groupby", 100, 800),
        _ev("cuda_runtime", "cudaLaunchKernel", 210, 5, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 610, 5, correlation=2),
        _ev("kernel", "seg_scan_lookback", 300, 120, tid=7, correlation=1,
            device=0, stream=7),
        _ev("kernel", "compact_lookback", 650, 80, tid=7, correlation=2,
            device=0, stream=7)]
    if program:
        evs += [_ev("cpu_op", "libgdf.op.groupby", 150, 700),
                _ev("cpu_op", "libgdf.groupby.sort", 160, 680),
                _ev("cpu_op", "libgdf.groupby.sort.scan", 200, 100),
                _ev("cpu_op", "libgdf.groupby.sort.extract", 600, 100)]
    return Trace({"traceEvents": evs})


@pytest.mark.parametrize("metric,want", [("groupby_scan_device_ms", 0.06),
                                         ("groupby_extract_device_ms", 0.04)])
def test_sort_phase_readers(metric, want):
    """Each reader gives the device ms a query launched inside its span,
    and None without a trace, without device events, or on a program
    without the span (an older commit)."""
    from gdfbench import spec
    from gdfbench.trace import Trace
    read = spec.reader(metric).read

    def ctx(trace):
        return {"trace": trace, "queries": 2, "filter_bytes": 0,
                "window_s": 1e-3, "exchange_s": None, "local_shards": 1}
    assert read(ctx(_trace(True))) == pytest.approx(want)
    assert read(ctx(_trace(False))) is None
    assert read(ctx(None)) is None
    assert read(ctx(Trace({"traceEvents": [
        _ev("user_annotation", "gdfbench.window", 0, 1000)]}))) is None
