"""TPC-H Q6 (gdfbench/queries/q6.py) over libgdf_tpu_torch against its
plain reference (gdfbench/reference/q6.py) on the CPU at SF 0.01-0.02:
the plan for every parameter of clause 2.4.6.3, its dates and discount
bounds, faults planted under a run, and the float32 control."""
import time

import pytest
import torch

from gdfbench import control, harness, mix as mixes, spec
from gdfbench.data import tpch
from gdfbench.harness import span_factory
from gdfbench.queries import q6
from gdfbench.reference import q6 as ref6
from gdfbench.tests._cells import SEED, small_cell
from libgdf_tpu_torch import ops

CELL = "tpch_sf10.q6"
SEEDS = [SEED, 7, 2 ** 32 + 5]
YEARS = range(1993, 1998)
# The discounts whose naive float bounds, DISCOUNT / 100 -+ 0.01, miss a
# stored value: 0.06 + 0.01 < 0.07, 0.07 - 0.01 > 0.06, 0.09 + 0.01 < 0.10.
NAIVE_MISSES = {"kind": "choice", "values": [6, 7, 9]}


def cell(sf: float, discount=None) -> dict:
    c = small_cell(CELL, sf)
    if discount is not None:
        c["mix"]["parameters"]["DISCOUNT"] = discount
    return c


@pytest.fixture(scope="module")
def dbs():
    return {seed: tpch.generate(0.01, seed) for seed in SEEDS}


def one_query(db, params: dict):
    """The plan's answer and its readings against the reference."""
    state = q6.prepare(db, cell(0.01)["config"])
    got = q6.run(state, params, span_factory(False))
    want = ref6.combine([ref6.reference(db, params)])
    return got, want, ref6.readings(got, want)


@pytest.mark.parametrize("discount", range(2, 10))
@pytest.mark.parametrize("seed", SEEDS)
def test_plan_equals_reference(dbs, seed, discount):
    """Every YEAR and QUANTITY at this DISCOUNT: the kept rows exact, the
    revenue within the cell's limit."""
    for year in YEARS:
        for quantity in (24, 25):
            params = {"YEAR": year, "DISCOUNT": discount,
                      "QUANTITY": quantity}
            got, want, r = one_query(dbs[seed], params)
            for k, limit in ref6.LIMITS.items():
                assert r[k] <= limit, (k, r[k], params)
            assert got.counts == {"filter.lineitem": want["filter.lineitem"]}
            assert want["filter.lineitem"] > 0, params
            assert got.answer["revenue"] > 0


def test_the_filter_keeps_about_two_percent(dbs):
    """A year of ship dates, three discounts and 23-24 quantities of 50:
    about 0.145 x 3/11 x 0.47, ~1.9% of the line items."""
    db = dbs[SEED]
    rows = db["lineitem"]["l_shipdate"].shape[0]
    kept = [ref6.reference(db, {"YEAR": y, "DISCOUNT": 6,
                                "QUANTITY": 24})["filter.lineitem"]
            for y in YEARS]
    assert 0.012 < sum(kept) / len(kept) / rows < 0.026


def test_dates_agree_with_the_calendar():
    """The plan's DATE32 (datetime) and the reference's (the leap rule)
    agree every new year of 1970-2100; 1995-03-01 is Q3's 9190."""
    for year in range(1970, 2101):
        assert q6.date32(year) == ref6.new_year(year), year
    assert q6.date32(1995) + 31 + 28 == 9190
    assert q6.date32(1993) == 8401 and q6.date32(1998) == 10227


def test_bounds_are_the_stored_doubles():
    """Each bound is the double the generator stores for that many
    hundredths (k / 100), where DISCOUNT / 100 -+ 0.01 is not."""
    stored = torch.arange(0, 11, dtype=torch.int64).to(torch.float64) / 100
    for d in range(2, 10):
        low, high = q6.discount_bounds(d)
        assert low == float(stored[d - 1]) and high == float(stored[d + 1])
        naive = (d / 100 - 0.01, d / 100 + 0.01)
        missed = naive[0] > float(stored[d - 1]) or \
            naive[1] < float(stored[d + 1])
        assert missed == (d in NAIVE_MISSES["values"]), d


def test_plan_reads_no_count_on_the_host(monkeypatch):
    """The sum takes the filter's device count: the plan passes
    `num_rows` and the library waits nowhere."""
    from libgdf_tpu_torch.utils import tracing
    seen = []
    real = ops.reduce

    def spy(col, op, num_rows=None):
        seen.append((op, num_rows))
        return real(col, op, num_rows=num_rows)
    monkeypatch.setattr(ops, "reduce", spy)
    db = tpch.generate(0.01, SEED)
    state = q6.prepare(db, cell(0.01)["config"])
    tracing.reset_counters()
    q6.run(state, {"YEAR": 1994, "DISCOUNT": 6, "QUANTITY": 24},
           span_factory(False))
    assert tracing.counters()["host_sync"] == 0
    (op, count), = seen
    assert op == "sum" and isinstance(count, torch.Tensor)
    assert count.dim() == 0 and count.dtype == torch.int32


def run_cell(sf: float, discount=None, seconds: float = 3.0) -> dict:
    """A window long enough for the 12 checked queries on a loaded host
    (2 ran in 0.5 s beside a parallel test run)."""
    torch.set_num_threads(2)
    return harness.run_single(cell(sf, discount), SEED, seconds, False,
                              "cpu", time.perf_counter())


def test_run_is_correct():
    out = run_cell(0.02)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(ref6.LIMITS)
    assert out["attempted"] >= 12 and out["failed"] == 0


def naive_bounds(monkeypatch):
    """The discount bounds as DISCOUNT / 100 -+ 0.01 in float64."""
    monkeypatch.setattr(q6, "discount_bounds",
                        lambda d: (d / 100 - 0.01, d / 100 + 0.01))
    return "filter_rows_gap"


def drop_a_kept_row(monkeypatch):
    """The filter's last kept row left out."""
    real = ops.filter_table

    def fake(table, stencil):
        t = real(table, stencil)
        return t.with_num_rows(t.num_rows - 1)
    monkeypatch.setattr(ops, "filter_table", fake)
    return "filter_rows_gap"


def sum_the_dead_rows(monkeypatch):
    """The sum reads the filter's dead rows, refilled with a large value
    (the CPU's compaction may leave zeros there)."""
    real_filter, real_reduce = ops.filter_table, ops.reduce

    def fill(table, stencil):
        t = real_filter(table, stencil)
        live = torch.arange(t.capacity) < t.num_rows
        cols = [c.with_data(torch.where(live, c.data, 1e6))
                for c in t.columns]
        return type(t).from_columns(cols).with_num_rows(t.num_rows)
    monkeypatch.setattr(ops, "filter_table", fill)
    monkeypatch.setattr(ops, "reduce",
                        lambda col, op, num_rows=None: real_reduce(col, op))
    return "revenue_rel_gap"


def revenue_high(monkeypatch):
    """The revenue 1e-6 high."""
    real = ops.reduce
    monkeypatch.setattr(ops, "reduce", lambda col, op, num_rows=None:
                        real(col, op, num_rows=num_rows) * (1 + 1e-6))
    return "revenue_rel_gap"


@pytest.mark.parametrize("fault", [naive_bounds, drop_a_kept_row,
                                   sum_the_dead_rows, revenue_high])
def test_fault_is_caught(monkeypatch, fault):
    reading = fault(monkeypatch)
    out = run_cell(0.01, NAIVE_MISSES)
    assert out["attempted"] >= 12
    assert not out["correct"], out["checks"]
    c = out["checks"][reading]
    assert c["value"] > c["limit"], out["checks"]


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_control_fails_and_float64_passes(seed):
    c = cell(0.02)
    low = control.control(c, seed, torch.device("cpu"), torch.float32)
    assert not low["correct"], low
    assert low["checks"]["filter_rows_gap"]["value"] == 0
    assert low["checks"]["revenue_rel_gap"]["value"] > 1e-8
    same = control.control(c, seed, torch.device("cpu"), torch.float64)
    assert same["correct"], same


def test_traffic_is_clause_2_4_6_3():
    mix = cell(0.01)["mix"]
    combos = mixes.combinations(mix)
    assert len(combos) == 80
    assert {(p["YEAR"], p["DISCOUNT"], p["QUANTITY"]) for p in combos} == {
        (y, d, q) for y in YEARS for d in range(2, 10) for q in (24, 25)}
    assert mix["loop"] == {"kind": "closed", "clients": 1}
    assert (mix["warmup_queries"], mix["check_queries"]) == (3, 12)
    s = mixes.stream(mix, 2 ** 31 + 5)
    first = [tuple(sorted(next(s).items())) for _ in range(80)]
    assert len(set(first)) == 80
