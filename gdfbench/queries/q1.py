"""TPC-H Q1, the pricing summary report (specification clause 2.4.1):

    select l_returnflag, l_linestatus, sum(l_quantity), sum(l_extendedprice),
           sum(l_extendedprice * (1 - l_discount)),
           sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)),
           avg(l_quantity), avg(l_extendedprice), avg(l_discount), count(*)
    from lineitem where l_shipdate <= date '1998-12-01' - interval DELTA day
    group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus

The plan: the filter (compare_scalar + filter_table, H1), the two
expressions (binary_op), the group-by (one sort of packed keys, H3 scans,
H1), the group count read on the host, then order_by over the groups and
the rows to the host.
"""
from __future__ import annotations

from libgdf_tpu_torch import ops

from ..roofline import filter_bytes
from . import QueryResult, host_columns, literal, to_table

SCANS = "lineitem"
LAST_SHIP = 10561                    # 1998-12-01 as DATE32
KEYS = ["l_returnflag", "l_linestatus"]
COLUMNS = ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
           "l_discount", "l_tax"]
AGGS = [("l_quantity", "sum", "sum_qty"),
        ("l_extendedprice", "sum", "sum_base_price"),
        ("disc_price", "sum", "sum_disc_price"),
        ("charge", "sum", "sum_charge"),
        ("l_quantity", "avg", "avg_qty"),
        ("l_extendedprice", "avg", "avg_price"),
        ("l_discount", "avg", "avg_disc"),
        ("l_quantity", "count", "count_order")]


def prepare(db: dict, config: dict) -> dict:
    types = config["lineitem"]["columns"]
    li = to_table(db["lineitem"], types)
    return {"lineitem": li}


def run(state: dict, params: dict, span) -> QueryResult:
    li = state["lineitem"]
    n = li.capacity
    with span("filter"):
        ship = li["l_shipdate"]
        keep = ops.compare_scalar(ship, LAST_SHIP - int(params["DELTA"]),
                                  "le")
        t = ops.filter_table(li.select(COLUMNS), keep)
    with span("project"):
        price, disc = t["l_extendedprice"], t["l_discount"]
        disc_price = ops.mul(price, ops.sub(literal(1.0, n, price.data),
                                            disc)).with_name("disc_price")
        charge = ops.mul(disc_price, ops.add(literal(1.0, n, price.data),
                                             t["l_tax"])).with_name("charge")
        t = t.with_column(disc_price).with_column(charge)
    with span("groupby"):
        g = ops.groupby(t, KEYS, AGGS).compact()
    with span("orderby"):
        g = g.gather(ops.order_by(g, KEYS))
    with span("fetch"):
        answer = host_columns(g)
        kept = int(t.num_rows)
    itemsizes = [c.data.element_size() for c in t.columns[:len(COLUMNS)]]
    nbytes = filter_bytes(n, [ship.data.element_size()] + itemsizes, kept,
                          itemsizes)
    return QueryResult(answer=answer,
                       counts={"filter.lineitem": kept,
                               "groups": len(answer["l_returnflag"])},
                       groups=None, filter_bytes=[nbytes])
