"""TPC-H Q3, the shipping priority query (specification clause 2.4.3):

    select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
           o_orderdate, o_shippriority
    from customer, orders, lineitem
    where c_mktsegment = SEGMENT and c_custkey = o_custkey
      and l_orderkey = o_orderkey and o_orderdate < DATE
      and l_shipdate > DATE
    group by l_orderkey, o_orderdate, o_shippriority
    order by revenue desc, o_orderdate limit 10

One card: each table filtered (H1) and sliced to its live rows, customer
joined to orders and orders to lineitem (sort-based joins, the smaller
side the build side), the revenue expression, the group-by, order_by of
the groups and the first 10 rows to the host.

Across processes (`run_dist`): the filters shard by shard, a
broadcast_join of the qualifying customers, the hash-shuffle dist_join of
lineitem with orders, dist_groupby, and the top 10: each shard's own,
gathered to every shard (all_gather_table), ordered again.
"""
from __future__ import annotations

import torch

from libgdf_tpu_torch import ops, parallel as par

from ..roofline import filter_bytes
from . import (QueryResult, host_columns, literal, project, sharded, shrink,
               to_table)

SCANS = "lineitem"
LIMIT = 10
CUSTOMER = ["c_custkey"]
ORDERS = ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"]
LINEITEM = ["l_orderkey", "l_extendedprice", "l_discount"]
BUILD = ["o_orderkey", "o_orderdate", "o_shippriority"]
KEYS = ["l_orderkey", "o_orderdate", "o_shippriority"]
AGGS = [("revenue", "sum", "revenue")]
ORDER = (["revenue", "o_orderdate"], [False, True])
GROUP_COLUMNS = KEYS + ["revenue"]


def prepare(db: dict, config: dict) -> dict:
    return {t: to_table(db[t], config[t]["columns"])
            for t in ("customer", "orders", "lineitem")}


def _width(table, names) -> list:
    return [table[n].data.element_size() for n in names]


def _filters(state, params):
    """(table, predicate column, stencil, kept columns) of each filter."""
    seg, date = int(params["SEGMENT"]), int(params["DATE"])
    c, o, li = state["customer"], state["orders"], state["lineitem"]
    return [
        ("customer", c, "c_mktsegment",
         lambda t: ops.compare_scalar(t["c_mktsegment"], seg, "eq"),
         CUSTOMER),
        ("orders", o, "o_orderdate",
         lambda t: ops.compare_scalar(t["o_orderdate"], date, "lt"), ORDERS),
        ("lineitem", li, "l_shipdate",
         lambda t: ops.compare_scalar(t["l_shipdate"], date, "gt"),
         LINEITEM),
    ]


def _revenue(t):
    price = t["l_extendedprice"]
    one = literal(1.0, t.capacity, price.data)
    return t.with_column(ops.mul(price, ops.sub(one, t["l_discount"]))
                         .with_name("revenue"))


def _top(t):
    return t.gather(ops.order_by(t, ORDER[0], ORDER[1])[:LIMIT])


def run(state: dict, params: dict, span) -> QueryResult:
    kept, nbytes = {}, []
    out = {}
    for name, table, pred, stencil, cols in _filters(state, params):
        with span("filter"):
            f = ops.filter_table(table.select(cols), stencil(table)).compact()
        kept[f"filter.{name}"] = f.capacity
        nbytes.append(filter_bytes(table.capacity,
                                   _width(table, [pred] + cols),
                                   f.capacity, _width(table, cols)))
        out[name] = f
        if name == "orders":
            with span("join"):
                co = ops.join(out["orders"], out["customer"], ["o_custkey"],
                              ["c_custkey"]).compact()
            kept["join.customer_orders"] = co.capacity
    with span("join"):
        lo = ops.join(out["lineitem"], co.select(BUILD), ["l_orderkey"],
                      ["o_orderkey"]).compact()
    kept["join.orders_lineitem"] = lo.capacity
    with span("project"):
        lo = _revenue(lo)
    with span("groupby"):
        g = ops.groupby(lo, KEYS, AGGS).compact()
    kept["groups"] = g.capacity
    with span("orderby"):
        top = _top(g)
    with span("fetch"):
        answer = host_columns(top)
    groups = {n: g[n].data for n in GROUP_COLUMNS}
    return QueryResult(answer=answer, counts=kept, groups=groups,
                       filter_bytes=nbytes)


# -- across processes -------------------------------------------------------

def prepare_dist(mesh, locals_: dict, counts: dict, config: dict) -> dict:
    """Set-up over a mesh: `locals_[table]` holds this process's shards
    ({column: tensor}, padded to one capacity), `counts[table]` every
    shard's live rows."""
    state = {t: sharded(locals_[t], counts[t], config[t]["columns"])
             for t in ("customer", "orders", "lineitem")}
    state["mesh"] = mesh
    state["live"] = counts
    return state


def run_dist(state: dict, params: dict, span) -> QueryResult:
    mesh = state["mesh"]
    seg, date = int(params["SEGMENT"]), int(params["DATE"])
    kept, nbytes = {}, []

    def filt(name, pred, stencil, cols):
        st = state[name]
        with span("filter"):
            f, counts = shrink(par.map_shards(
                mesh, lambda t: ops.filter_table(t.select(cols), stencil(t)),
                st))
        kept[f"filter.{name}"] = counts
        live = state["live"][name]
        for i, rank in enumerate(mesh.local_ranks):
            s = st.shards[i]
            nbytes.append(filter_bytes(live[rank], _width(s, [pred] + cols),
                                       counts[rank], _width(s, cols)))
        return f

    c = filt("customer", "c_mktsegment",
             lambda t: ops.compare_scalar(t["c_mktsegment"], seg, "eq"),
             CUSTOMER)
    o = filt("orders", "o_orderdate",
             lambda t: ops.compare_scalar(t["o_orderdate"], date, "lt"),
             ORDERS)
    with span("join"):
        co, counts = shrink(par.broadcast_join(
            mesh, o, c, ["o_custkey"], ["c_custkey"],
            out_capacity_per_shard=o.shards[0].capacity))
    kept["join.customer_orders"] = counts
    li = filt("lineitem", "l_shipdate",
              lambda t: ops.compare_scalar(t["l_shipdate"], date, "gt"),
              LINEITEM)
    with span("join"):
        lo, counts = shrink(par.dist_join(
            mesh, li, project(co, BUILD), ["l_orderkey"], ["o_orderkey"],
            out_capacity_per_shard=li.shards[0].capacity))
    kept["join.orders_lineitem"] = counts
    with span("project"):
        lo = par.ShardedTable(shards=tuple(_revenue(s) for s in lo.shards),
                              counts=lo.counts, overflow=lo.overflow)
    with span("groupby"):
        g, counts = shrink(par.dist_groupby(mesh, lo, KEYS, AGGS))
    kept["groups"] = counts
    with span("orderby"):
        top = par.map_shards(mesh, _gather_top, g)
    with span("fetch"):
        rows = int(top.counts[mesh.local_ranks[0]])
        answer = host_columns(top.shards[0].with_num_rows(rows))
    groups = {name: torch.cat([
        s[name].data[:counts[rank]] for s, rank in zip(g.shards,
                                                       mesh.local_ranks)])
        for name in GROUP_COLUMNS}
    return QueryResult(answer=answer, counts=kept, groups=groups,
                       filter_bytes=nbytes)


def _gather_top(t):
    """Shard-local: this shard's first LIMIT groups, every shard's gathered
    (all_gather_table), ordered again: the query's LIMIT rows, the same on
    every shard, at capacity LIMIT."""
    live = t.row_count()
    perm = ops.order_by(t, ORDER[0], ORDER[1])
    idx = perm[:LIMIT]
    if idx.shape[0] < LIMIT:
        idx = torch.cat([idx, idx.new_zeros(LIMIT - idx.shape[0])])
    mine = t.gather(idx, num_rows=torch.clamp(torch.as_tensor(live),
                                               max=LIMIT))
    every = par.all_gather_table(mine, par.DEFAULT_AXIS)
    perm = ops.order_by(every, ORDER[0], ORDER[1])[:LIMIT]
    return every.gather(perm, num_rows=torch.clamp(every.num_rows, max=LIMIT))
