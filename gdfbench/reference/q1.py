"""TPC-H Q1 in plain torch, and the comparison of an answer with it.

The reference filters with a mask and sums each (l_returnflag,
l_linestatus) group with a masked sum, in `dtype`: float64 is the
configuration's DECIMAL; float32 is the control, the step below it.
"""
from __future__ import annotations

import torch

from . import count_gap, rel_gap

LAST_SHIP = 10561                    # 1998-12-01 as DATE32
SUMS = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge")
AVGS = ("avg_qty", "avg_price", "avg_disc")
KEYS = ("l_returnflag", "l_linestatus")
# Each reading's limit, from the readings in PERF.md (section 2).
LIMITS = {"filter_rows_gap": 0, "group_key_gap": 0, "count_gap": 0,
          "agg_rel_gap": 1e-9}


def reference(db: dict, params: dict, dtype=torch.float64) -> dict:
    li = db["lineitem"]
    keep = li["l_shipdate"] <= LAST_SHIP - int(params["DELTA"])
    flag = li["l_returnflag"].to(torch.int64)
    status = li["l_linestatus"].to(torch.int64)
    qty = li["l_quantity"].to(dtype)
    price = li["l_extendedprice"].to(dtype)
    disc = li["l_discount"].to(dtype)
    tax = li["l_tax"].to(dtype)
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + tax)
    gid = torch.where(keep, flag * 256 + status, -1)
    present = torch.unique(gid[keep]).tolist()
    out = {k: [] for k in KEYS + SUMS + AVGS + ("count_order",)}
    for g in sorted(present):
        m = gid == g
        count = int(m.sum())

        def total(x):
            return float(torch.where(m, x, torch.zeros((), dtype=dtype,
                                                       device=x.device))
                         .sum(dtype=dtype))
        sums = [total(qty), total(price), total(disc_price), total(charge)]
        out["l_returnflag"].append(g // 256)
        out["l_linestatus"].append(g % 256)
        for name, v in zip(SUMS, sums):
            out[name].append(v)
        out["avg_qty"].append(float(torch.tensor(sums[0], dtype=dtype)
                                    / count))
        out["avg_price"].append(float(torch.tensor(sums[1], dtype=dtype)
                                      / count))
        out["avg_disc"].append(float(torch.tensor(total(disc), dtype=dtype)
                                     / count))
        out["count_order"].append(count)
    out["filter.lineitem"] = int(keep.sum())
    return out


def combine(parts: list) -> dict:
    """The whole query from its chunks' references: Q1 has one chunk."""
    if len(parts) != 1:
        raise ValueError("Q1's reference takes the whole lineitem table")
    return parts[0]


def readings(result, want: dict) -> dict:
    """The numbers compared: the filter's kept rows, the groups' keys in
    order, their counts (all exact), and the widest relative gap of a sum
    or an average."""
    answer, counts = result.answer, result.counts
    n_got, n_want = len(answer["l_returnflag"]), len(want["l_returnflag"])
    key_gap = abs(n_got - n_want)
    rows = min(n_got, n_want)
    for k in KEYS:
        key_gap += sum(int(a) != int(b) for a, b in
                       zip(list(answer[k][:rows]), want[k][:rows]))
    agg = 0.0
    for name in SUMS + AVGS:
        agg = max(agg, rel_gap(answer[name][:rows], want[name][:rows]))
    return {
        "filter_rows_gap": count_gap(counts["filter.lineitem"],
                                     want["filter.lineitem"]),
        "group_key_gap": key_gap,
        "count_gap": count_gap(list(answer["count_order"][:rows]),
                               want["count_order"][:rows]),
        "agg_rel_gap": agg,
    }
