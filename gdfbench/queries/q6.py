"""TPC-H Q6, the forecasting revenue change query (specification clause
2.4.6):

    select sum(l_extendedprice * l_discount) as revenue from lineitem
    where l_shipdate >= date 'DATE'
      and l_shipdate < date 'DATE' + interval '1' year
      and l_discount between DISCOUNT - 0.01 and DISCOUNT + 0.01
      and l_quantity < QUANTITY

DATE is 1 January of YEAR; DISCOUNT is given in hundredths. The plan: the
five comparisons and their AND into one stencil, the filter of the two
columns the sum reads (H1), the product, the sum over the filter's live
rows (its count stays on the card), and the revenue and the kept count to
the host in one copy.

DECIMAL(15,2) is held as float64: the column holds k / 100 for a whole
number of hundredths k. DISCOUNT - 0.01 in float64 is not always such a
value (0.07 - 0.01 is 0.060000000000000005, and 0.06 + 0.01 is
0.06999999999999999), so each bound is made in hundredths first, as
(DISCOUNT -+ 1) / 100: the very double the column holds.
"""
from __future__ import annotations

import datetime

import torch

from libgdf_tpu_torch import ops

from ..roofline import filter_bytes
from . import QueryResult, to_table

SCANS = "lineitem"
KEPT = ["l_extendedprice", "l_discount"]
READ = ["l_shipdate", "l_quantity"] + KEPT       # each column once
EPOCH = datetime.date(1970, 1, 1)


def date32(year: int) -> int:
    """1 January of `year` as DATE32: days since 1970-01-01."""
    return (datetime.date(year, 1, 1) - EPOCH).days


def discount_bounds(discount: int) -> tuple:
    """The BETWEEN's two bounds for DISCOUNT in hundredths, each the
    float64 that the column holds for that many hundredths."""
    return (discount - 1) / 100, (discount + 1) / 100


def prepare(db: dict, config: dict) -> dict:
    types = config["lineitem"]["columns"]
    return {"lineitem": to_table(db["lineitem"], types)}


def run(state: dict, params: dict, span) -> QueryResult:
    li = state["lineitem"]
    year = int(params["YEAR"])
    low, high = discount_bounds(int(params["DISCOUNT"]))
    with span("filter"):
        ship, disc = li["l_shipdate"], li["l_discount"]
        stencils = [
            ops.compare_scalar(ship, date32(year), "ge"),
            ops.compare_scalar(ship, date32(year + 1), "lt"),
            ops.compare_scalar(disc, low, "ge"),
            ops.compare_scalar(disc, high, "le"),
            ops.compare_scalar(li["l_quantity"], int(params["QUANTITY"]),
                               "lt")]
        keep = stencils[0]
        for s in stencils[1:]:
            keep = ops.bitwise_and(keep, s)
        t = ops.filter_table(li.select(KEPT), keep)
    with span("project"):
        revenue = ops.mul(t["l_extendedprice"], t["l_discount"])
    with span("groupby"):
        total = ops.reduce(revenue, "sum", num_rows=t.num_rows)
    with span("fetch"):
        both = torch.stack([total, t.num_rows.to(total.dtype)]).cpu()
        revenue_sum, kept = float(both[0]), int(both[1])
    n = li.capacity
    read = [li[c].data.element_size() for c in READ]
    written = [t[c].data.element_size() for c in KEPT]
    return QueryResult(answer={"revenue": revenue_sum},
                       counts={"filter.lineitem": kept},
                       filter_bytes=[filter_bytes(n, read, kept, written)])
