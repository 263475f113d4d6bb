"""TPC-H Q6 in plain torch, and the comparison of an answer with it.

The reference compares in whole units, apart from the program's float
bounds: ship dates as DATE32 days against 1 January of YEAR and of the
next year (worked out from the civil calendar's leap rule), the discount
as round(l_discount * 100) in integer hundredths against DISCOUNT -+ 1,
and the quantity (a whole number) against QUANTITY. The kept rows'
l_extendedprice * l_discount is summed in `dtype`: float64 is the
configuration's DECIMAL; float32 is the control, the step below it.
"""
from __future__ import annotations

import torch

from . import count_gap, rel_gap

# Each reading's limit (PERF.md, section 2). The kept rows are exact. The
# revenue is one float64 sum of ~1.1M products at SF 10, in another order
# than the program's at most: ~1e-16 relative, as Q3's revenue; float32
# gives ~1e-7.
LIMITS = {"filter_rows_gap": 0, "revenue_rel_gap": 1e-9}


def _leaps_before(year: int) -> int:
    """Leap years in 1..year-1 of the proleptic Gregorian calendar."""
    y = year - 1
    return y // 4 - y // 100 + y // 400


def new_year(year: int) -> int:
    """1 January of `year` as DATE32: days since 1 January 1970."""
    return 365 * (year - 1970) + _leaps_before(year) - _leaps_before(1970)


def reference(db: dict, params: dict, dtype=torch.float64) -> dict:
    li = db["lineitem"]
    year, discount = int(params["YEAR"]), int(params["DISCOUNT"])
    ship = li["l_shipdate"].long()
    hundredths = torch.round(li["l_discount"] * 100).long()
    keep = ((ship >= new_year(year)) & (ship < new_year(year + 1))
            & (hundredths >= discount - 1) & (hundredths <= discount + 1)
            & (li["l_quantity"] < int(params["QUANTITY"])))
    price = li["l_extendedprice"][keep].to(dtype)
    disc = li["l_discount"][keep].to(dtype)
    return {"revenue": float((price * disc).sum(dtype=dtype)),
            "filter.lineitem": int(keep.sum())}


def combine(parts: list) -> dict:
    """The whole query from its chunks' references: Q6 has one chunk."""
    if len(parts) != 1:
        raise ValueError("Q6's reference takes the whole lineitem table")
    return parts[0]


def readings(result, want: dict) -> dict:
    """The filter's kept rows (exact) and the revenue's relative gap."""
    return {"filter_rows_gap": count_gap(result.counts["filter.lineitem"],
                                         want["filter.lineitem"]),
            "revenue_rel_gap": rel_gap(result.answer["revenue"],
                                       want["revenue"])}
