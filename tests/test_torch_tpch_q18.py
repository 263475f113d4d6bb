"""TPC-H Q18 (gdfbench/queries/q18.py) over libgdf_tpu_torch against its
plain reference (gdfbench/reference/q18.py) on the CPU at SF 0.01-0.02:
the plan, o_totalprice, faults planted under a run, and the float32
control. At these scales QUANTITY 312..315 keeps at most an order or two,
so QUANTITY 150, 200 and 250 give the joins and the last group-by rows."""
import time

import pytest
import torch

from gdfbench import control, harness, mix as mixes, spec
from gdfbench.data import tpch, totalprice
from gdfbench.harness import span_factory
from gdfbench.queries import q18
from gdfbench.tests._cells import SEED, small_cell
from libgdf_tpu_torch import ops
from libgdf_tpu_torch.utils import tracing

CELL = "tpch_sf10_q18.q18"
SEEDS = [SEED, 7, 2 ** 32 + 5]
LOW = {"kind": "int_range", "low": 150, "high": 250}


def cell(sf: float, quantity=None) -> dict:
    c = small_cell(CELL, sf)
    if quantity is not None:
        c["mix"]["parameters"]["QUANTITY"] = quantity
    return c


def one_query(db, quantity: int, dtype=torch.float64):
    """The plan's answer and its readings against the reference."""
    rmod = spec.reference("q18")
    state = q18.prepare(db, cell(0.01)["config"])
    got = q18.run(state, {"QUANTITY": quantity}, span_factory(False))
    want = rmod.combine([rmod.reference(db, {"QUANTITY": quantity}, dtype)])
    return got, want, rmod.readings(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("quantity", [150, 200, 250, 312])
def test_plan_equals_reference(seed, quantity):
    db = tpch.generate(0.01, seed)
    got, want, r = one_query(db, quantity)
    rmod = spec.reference("q18")
    for k, limit in rmod.LIMITS.items():
        assert r[k] <= limit, (k, r[k], quantity)
    assert got.counts == want["counts"]
    if quantity < 300:
        assert 0 < got.counts["groups"] == got.counts["having"]
        assert len(got.answer["o_orderkey"]) == min(100,
                                                    got.counts["groups"])


def test_plan_at_sf_002_with_the_cells_own_quantities():
    db = tpch.generate(0.02, SEED)
    for quantity in range(312, 316):
        _, _, r = one_query(db, quantity)
        assert all(v == 0 for v in r.values()), (quantity, r)


def test_the_subquery_takes_the_sort_path_over_every_line():
    """The group-by on l_orderkey takes the wide path over every line item
    (its keys span about one slot a line item, past the dense path's 8,
    and H7's slot arrays take a third of the sort path's buffers), so no
    line item is sorted; the outer group-by's float key sends it to the
    sort path without a probe."""
    db = tpch.generate(0.01, SEED)
    state = q18.prepare(db, cell(0.01)["config"])
    tracing.reset_counters()
    res = q18.run(state, {"QUANTITY": 200}, span_factory(False))
    c = tracing.counters()
    lines = db["lineitem"]["l_orderkey"].shape[0]
    assert c["groupby.wide"] == c["groupby.sort"] == 1
    assert "groupby.dense" not in c
    assert c["groupby.sort.rows"] == res.counts["join.lineitem"] < lines
    assert c["host_sync.groupby.domain"] == 1
    total = float(db["lineitem"]["l_quantity"].sum())
    assert float(res.groups["sum_qty_total"]) == total


def test_o_totalprice_by_hand():
    """Two orders of hand-made lines with known cents: dbgen's term
    truncates after the discount and again after the tax."""
    orders = {"o_orderkey": torch.tensor([1, 3], dtype=torch.int32)}
    cents = torch.tensor([123457, 99999, 1000000], dtype=torch.int64)
    lineitem = {
        "l_orderkey": torch.tensor([3, 1, 3], dtype=torch.int32),
        "l_extendedprice": cents.to(torch.float64) / 100,
        "l_discount": torch.tensor([7, 0, 10], dtype=torch.float64) / 100,
        "l_tax": torch.tensor([3, 8, 0], dtype=torch.float64) / 100}
    # 123457 * 93 // 100 = 114815, * 103 // 100 = 118259
    # 99999 * 100 // 100 = 99999, * 108 // 100 = 107998
    # 1000000 * 90 // 100 = 900000, * 100 // 100 = 900000
    got = totalprice.o_totalprice({"orders": orders, "lineitem": lineitem})
    assert got.dtype == torch.float64
    assert got.tolist() == [1079.98, (118259 + 900000) / 100]
    assert totalprice.line_charge_cents(
        lineitem["l_extendedprice"], lineitem["l_discount"],
        lineitem["l_tax"]).tolist() == [118259, 107998, 900000]


def test_o_totalprice_of_generated_orders():
    """Every generated order gets its own lines' sum, below the exact
    decimal charge by less than a line's two truncations (a cent after the
    discount, grown by the tax, and a cent after the tax)."""
    db = tpch.generate(0.01, SEED)
    got = totalprice.o_totalprice(db)
    li = db["lineitem"]
    exact = (li["l_extendedprice"] * (1 - li["l_discount"])
             * (1 + li["l_tax"]))
    index = torch.searchsorted(db["orders"]["o_orderkey"].long(),
                               li["l_orderkey"].long())
    want = torch.zeros_like(got).index_add_(0, index, exact)
    lines = torch.bincount(index, minlength=got.shape[0])
    assert (got <= want + 1e-6).all()
    assert (want - got < 0.0109 * lines + 0.01 * lines + 1e-6).all()
    assert torch.equal(torch.round(got * 100) / 100, got)      # whole cents


def run_cell(sf: float, quantity=None, seconds: float = 0.5) -> dict:
    torch.set_num_threads(2)
    return harness.run_single(cell(sf, quantity), SEED, seconds, False,
                              "cpu", time.perf_counter())


def test_run_is_correct():
    out = run_cell(0.02)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(spec.reference("q18").LIMITS)
    assert out["attempted"] >= 2 and out["failed"] == 0


def drop_a_line(monkeypatch):
    """One line item left out of the subquery's group-by."""
    real = ops.groupby

    def fake(table, keys, aggs, dropna=True):
        if list(keys) == ["l_orderkey"]:
            table = type(table).from_columns(
                [c.with_data(c.data[1:]) for c in table.columns])
        return real(table, keys, aggs, dropna)
    monkeypatch.setattr(ops, "groupby", fake)
    return "qty_total_gap"


def nudge_totalprice(monkeypatch):
    """o_totalprice one cent high in the plan's orders."""
    real = totalprice.o_totalprice
    monkeypatch.setattr(q18, "o_totalprice", lambda db: real(db) + 0.01)
    return "totalprice_rel_gap"


@pytest.mark.parametrize("fault", [drop_a_line, nudge_totalprice])
def test_fault_is_caught(monkeypatch, fault):
    reading = fault(monkeypatch)
    out = run_cell(0.01, LOW)
    assert out["attempted"] >= 2
    assert not out["correct"], out["checks"]
    c = out["checks"][reading]
    assert c["value"] > c["limit"], out["checks"]


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_control_fails_and_float64_passes(seed):
    c = cell(0.02, LOW)
    low = control.control(c, seed, torch.device("cpu"), torch.float32)
    assert not low["correct"], low
    assert low["checks"]["totalprice_rel_gap"]["value"] > 0
    same = control.control(c, seed, torch.device("cpu"), torch.float64)
    assert same["correct"], same


def test_traffic_is_clause_2_4_18_3():
    mix = cell(0.01)["mix"]
    combos = mixes.combinations(mix)
    assert [p["QUANTITY"] for p in combos] == [312, 313, 314, 315]
    assert mix["loop"] == {"kind": "closed", "clients": 1}
