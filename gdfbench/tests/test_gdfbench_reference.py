"""The plain references on hand-worked tables, and their comparisons."""
from types import SimpleNamespace

import pytest
import torch

from gdfbench.reference import count_gap, q1, q3, rel_gap


def f64(*v):
    return torch.tensor(v, dtype=torch.float64)


def i32(*v):
    return torch.tensor(v, dtype=torch.int32)


def i8(*v):
    return torch.tensor(v, dtype=torch.int8)


LINEITEM_Q1 = {
    "l_shipdate": i32(10000, 10000, 10500, 10550, 10400),
    "l_returnflag": i8(0, 0, 1, 1, 2), "l_linestatus": i8(0, 0, 1, 1, 0),
    "l_quantity": f64(10, 20, 5, 7, 1),
    "l_extendedprice": f64(100, 200, 50, 70, 10),
    "l_discount": f64(0.1, 0.0, 0.05, 0.0, 0.1),
    "l_tax": f64(0.0, 0.08, 0.02, 0.0, 0.05),
}


def test_q1_by_hand():
    want = q1.reference({"lineitem": LINEITEM_Q1}, {"DELTA": 60})
    # 1998-12-01 - 60 days = 10501: the row shipped on 10550 is out
    assert want["filter.lineitem"] == 4
    assert want["l_returnflag"] == [0, 1, 2]
    assert want["l_linestatus"] == [0, 1, 0]
    assert want["count_order"] == [2, 1, 1]
    assert want["sum_qty"] == pytest.approx([30, 5, 1])
    assert want["sum_base_price"] == pytest.approx([300, 50, 10])
    assert want["sum_disc_price"] == pytest.approx([290, 47.5, 9])
    assert want["sum_charge"] == pytest.approx([306, 48.45, 9.45])
    assert want["avg_qty"] == pytest.approx([15, 5, 1])
    assert want["avg_price"] == pytest.approx([150, 50, 10])
    assert want["avg_disc"] == pytest.approx([0.05, 0.05, 0.1])


def test_q1_readings_see_each_difference():
    want = q1.reference({"lineitem": LINEITEM_Q1}, {"DELTA": 60})
    good = SimpleNamespace(answer=dict(want), counts={"filter.lineitem": 4})
    r = q1.readings(good, want)
    assert r == {"filter_rows_gap": 0, "group_key_gap": 0, "count_gap": 0,
                 "agg_rel_gap": 0.0}
    bad = dict(want, sum_charge=[306 * (1 + 1e-6), 48.45, 9.45],
               l_linestatus=[0, 0, 0], count_order=[2, 1, 2])
    r = q1.readings(SimpleNamespace(answer=bad,
                                    counts={"filter.lineitem": 3}), want)
    assert r["filter_rows_gap"] == 1 and r["group_key_gap"] == 1
    assert r["count_gap"] == 1
    assert r["agg_rel_gap"] == pytest.approx(1e-6, rel=1e-3)


DB_Q3 = {
    "customer": {"c_custkey": i32(1, 2, 3, 4), "c_mktsegment": i8(0, 0, 0, 1)},
    "orders": {"o_orderkey": i32(1, 2, 3, 4), "o_custkey": i32(1, 2, 1, 4),
               "o_orderdate": i32(9000, 9000, 9300, 9100),
               "o_shippriority": i32(0, 0, 0, 0)},
    "lineitem": {"l_orderkey": i32(1, 1, 2, 3, 4, 4),
                 "l_shipdate": i32(9200, 9100, 9250, 9350, 9200, 9300),
                 "l_extendedprice": f64(100, 200, 300, 400, 500, 600),
                 "l_discount": f64(0.1, 0, 0, 0, 0.5, 0)},
}


def test_q3_by_hand():
    want = q3.combine([q3.reference(DB_Q3, {"SEGMENT": 0, "DATE": 9190})])
    assert want["counts"] == {"filter.customer": 3, "filter.orders": 3,
                              "join.customer_orders": 2,
                              "filter.lineitem": 5,
                              "join.orders_lineitem": 2, "groups": 2}
    assert want["groups"]["l_orderkey"].tolist() == [1, 2]
    assert want["groups"]["revenue"].tolist() == pytest.approx([90, 300])
    assert want["top"]["l_orderkey"].tolist() == [2, 1]


def test_q3_chunks_with_every_customer():
    """Two chunks, the customers of both for the lookup: the parts combine
    to the whole."""
    whole = q3.combine([q3.reference(DB_Q3, {"SEGMENT": 0, "DATE": 9190})])
    c = DB_Q3["customer"]
    halves = []
    for lo, hi in ((0, 2), (2, 4)):
        o = {k: v[lo:hi] for k, v in DB_Q3["orders"].items()}
        keys = set(o["o_orderkey"].tolist())
        m = torch.tensor([k in keys for k in
                          DB_Q3["lineitem"]["l_orderkey"].tolist()])
        li = {k: v[m] for k, v in DB_Q3["lineitem"].items()}
        cust = {k: v[lo:hi] for k, v in c.items()}
        halves.append(q3.reference({"customer": cust, "orders": o,
                                    "lineitem": li},
                                   {"SEGMENT": 0, "DATE": 9190},
                                   customers=c))
    both = q3.combine(halves)
    assert both["counts"] == whole["counts"]
    assert torch.equal(both["top"]["l_orderkey"], whole["top"]["l_orderkey"])


def test_q3_readings_see_each_difference():
    want = q3.combine([q3.reference(DB_Q3, {"SEGMENT": 0, "DATE": 9190})])
    groups = {k: v.clone() for k, v in want["groups"].items()}
    answer = {k: v.tolist() for k, v in want["top"].items()}
    good = SimpleNamespace(answer=answer, counts=dict(want["counts"]),
                           groups=groups)
    assert set(q3.readings(good, want).values()) == {0}
    dup = {k: torch.cat([v, v[:1]]) for k, v in groups.items()}
    bad = SimpleNamespace(answer=dict(answer, l_orderkey=[1, 2]),
                          counts=dict(want["counts"], **{
                              "join.orders_lineitem": [1, 2]}),
                          groups=dup)
    r = q3.readings(bad, want)
    assert r["group_key_gap"] == 1 and r["join_rows_gap"] == 1
    assert r["top_gap"] == 2


def test_gaps():
    assert rel_gap([1.0, 2.0], [1.0, 2.0 * (1 + 1e-9)]) == \
        pytest.approx(1e-9, rel=1e-6)
    assert rel_gap([0.5], [0.0]) == 0.5
    assert count_gap([1, 2], [1, 3]) == 1 and count_gap(5, 7) == 2
