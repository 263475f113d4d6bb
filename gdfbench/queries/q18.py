"""TPC-H Q18, the large volume customer query (specification clause
2.4.18):

    select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
           sum(l_quantity)
    from customer, orders, lineitem
    where o_orderkey in (select l_orderkey from lineitem
                         group by l_orderkey
                         having sum(l_quantity) > QUANTITY)
      and c_custkey = o_custkey and o_orderkey = l_orderkey
    group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
    order by o_totalprice desc, o_orderdate limit 100

One card: the subquery's group-by of all of lineitem on l_orderkey (one
group an order), the HAVING as a filter of its groups (H1), orders joined
to the keys that pass (the IN), customer to those orders, lineitem to
them again (the outer query's own join: it does not reuse the subquery's
sums), the group-by on the four keys, and the first 100 rows to the host.
c_name ("Customer#" and c_custkey in 9 digits) is a function of c_custkey
and is not held: the answer carries c_custkey.
"""
from __future__ import annotations

from libgdf_tpu_torch import ops

from ..data.totalprice import o_totalprice
from ..roofline import filter_bytes
from . import QueryResult, host_columns, to_table

SCANS = "lineitem"
LIMIT = 100
SUB = ["l_orderkey", "l_quantity"]
HAVING = ["l_orderkey", "sum_qty"]
ORDERS = ["o_orderkey", "o_custkey", "o_orderdate", "o_totalprice"]
KEYS = ["c_custkey", "l_orderkey", "o_orderdate", "o_totalprice"]
SUM_QTY = [("l_quantity", "sum", "sum_qty")]
ORDER = (["o_totalprice", "o_orderdate"], [False, True])
# The answer's name of each column of the last group-by (the join keeps
# lineitem's name of the order key).
ANSWER = {"c_custkey": "c_custkey", "l_orderkey": "o_orderkey",
          "o_orderdate": "o_orderdate", "o_totalprice": "o_totalprice",
          "sum_qty": "sum_qty"}


def prepare(db: dict, config: dict) -> dict:
    """The three tables as the library's Tables, orders with its
    o_totalprice, made from the line items (set-up, like the tables)."""
    orders = dict(db["orders"], o_totalprice=o_totalprice(db))
    tables = dict(db, orders=orders)
    return {t: to_table(tables[t], config[t]["columns"])
            for t in ("customer", "orders", "lineitem")}


def run(state: dict, params: dict, span) -> QueryResult:
    quantity = int(params["QUANTITY"])
    c, o, li = state["customer"], state["orders"], state["lineitem"]
    kept = {}
    with span("groupby"):
        g = ops.groupby(li.select(SUB), ["l_orderkey"], SUM_QTY).compact()
    kept["subquery.groups"] = g.capacity
    with span("filter"):
        h = ops.filter_table(g.select(HAVING), ops.compare_scalar(
            g["sum_qty"], quantity, "gt")).compact()
    kept["having"] = h.capacity
    width = [g[n].data.element_size() for n in HAVING]
    nbytes = [filter_bytes(g.capacity, width, h.capacity, width)]
    with span("join"):
        # The IN: the subquery's keys are a group-by's, so unique, and an
        # inner join with them gives each order at most once, the rows of
        # the semi-join.
        oh = ops.join(o.select(ORDERS), h.select(["l_orderkey"]),
                      ["o_orderkey"], ["l_orderkey"]).compact()
    kept["join.orders"] = oh.capacity
    with span("join"):
        co = ops.join(c.select(["c_custkey"]), oh, ["c_custkey"],
                      ["o_custkey"]).compact()
    kept["join.customer"] = co.capacity
    with span("join"):
        lo = ops.join(li.select(SUB), co, ["l_orderkey"],
                      ["o_orderkey"]).compact()
    kept["join.lineitem"] = lo.capacity
    with span("groupby"):
        f = ops.groupby(lo, KEYS, SUM_QTY).compact()
    kept["groups"] = f.capacity
    with span("orderby"):
        top = f.gather(ops.order_by(f, ORDER[0], ORDER[1])[:LIMIT])
    with span("fetch"):
        answer = {ANSWER[k]: v for k, v in host_columns(top).items()}
    # For the check, beside the answer: the HAVING's rows, every group, and
    # the sum over all 15M-odd subquery groups (one reduction on the card,
    # no host read), so that each group of the large group-by counts.
    groups = {"having.l_orderkey": h["l_orderkey"].data,
              "having.sum_qty": h["sum_qty"].data,
              "sum_qty_total": g["sum_qty"].data.sum(),
              **{ANSWER[k]: f[k].data for k in KEYS + ["sum_qty"]}}
    return QueryResult(answer=answer, counts=kept, groups=groups,
                       filter_bytes=nbytes)
