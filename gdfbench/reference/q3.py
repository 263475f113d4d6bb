"""TPC-H Q3 in plain torch, and the comparison of an answer with it.

The reference marks the qualifying customers in a table indexed by key,
finds each line item's order by a binary search over the sorted order
keys, and sums the revenue of each order with index_add, in `dtype`
(float64, the configuration's DECIMAL; float32 for the control). Every
group is (l_orderkey, o_orderdate, o_shippriority); an order key fixes the
other two. `customer` may be the whole table while `orders` and
`lineitem` are one chunk: each order's line items lie in its chunk.
"""
from __future__ import annotations

import torch

from . import count_gap, rel_gap

LIMIT = 10
GROUP_COLUMNS = ("l_orderkey", "o_orderdate", "o_shippriority", "revenue")
# Each reading's limit, from the readings in PERF.md (section 2).
LIMITS = {"filter_rows_gap": 0, "join_rows_gap": 0, "group_key_gap": 0,
          "revenue_rel_gap": 1e-9, "top_gap": 0}


def reference(db: dict, params: dict, dtype=torch.float64,
              customers: dict | None = None) -> dict:
    """The counts and groups of one chunk's orders and line items; the
    customers that qualify are looked up in `customers` (by default the
    chunk's own), the customer count is the chunk's."""
    seg, date = int(params["SEGMENT"]), int(params["DATE"])
    c, o, li = db["customer"], db["orders"], db["lineitem"]
    every = c if customers is None else customers
    dev = o["o_orderkey"].device
    c_keep = c["c_mktsegment"] == seg
    e_keep = every["c_mktsegment"] == seg
    qualifies = torch.zeros(int(every["c_custkey"].max()) + 2,
                            dtype=torch.bool, device=dev)
    qualifies[every["c_custkey"][e_keep].long()] = True
    o_date = o["o_orderdate"] < date
    cust = o["o_custkey"].long().clamp(max=qualifies.shape[0] - 1)
    o_keep = o_date & qualifies[cust]
    l_keep = li["l_shipdate"] > date

    keys, perm = torch.sort(o["o_orderkey"].long())
    lk = li["l_orderkey"].long()
    pos = torch.searchsorted(keys, lk).clamp(max=keys.shape[0] - 1)
    found = keys[pos] == lk
    order = perm[pos]
    sel = l_keep & found & o_keep[order]
    price = li["l_extendedprice"].to(dtype)
    revenue = price * (1 - li["l_discount"].to(dtype))
    per_order = torch.zeros(o["o_orderkey"].shape[0], dtype=dtype,
                            device=dev)
    per_order.index_add_(0, order[sel], revenue[sel])
    lines = torch.zeros(o["o_orderkey"].shape[0], dtype=torch.int64,
                        device=dev)
    lines.index_add_(0, order[sel], torch.ones_like(order[sel]))
    has = lines > 0
    idx = torch.nonzero(has).flatten()
    groups = {"l_orderkey": o["o_orderkey"][idx].long(),
              "o_orderdate": o["o_orderdate"][idx].long(),
              "o_shippriority": o["o_shippriority"][idx].long(),
              "revenue": per_order[idx]}
    return {
        "counts": {"filter.customer": int(c_keep.sum()),
                   "filter.orders": int(o_date.sum()),
                   "join.customer_orders": int(o_keep.sum()),
                   "filter.lineitem": int(l_keep.sum()),
                   "join.orders_lineitem": int(sel.sum()),
                   "groups": int(idx.shape[0])},
        "groups": {k: v.cpu() for k, v in groups.items()},
    }


def combine(parts: list) -> dict:
    """The whole query from its chunks' references: counts summed, groups
    concatenated, and the first LIMIT groups by revenue descending, then
    o_orderdate (two stable sorts)."""
    counts = {k: sum(p["counts"][k] for p in parts)
              for k in parts[0]["counts"]}
    groups = {k: torch.cat([p["groups"][k] for p in parts])
              for k in GROUP_COLUMNS}
    by_date = torch.sort(groups["o_orderdate"], stable=True).indices
    by_rev = torch.sort(-groups["revenue"][by_date].double(),
                        stable=True).indices
    top = by_date[by_rev][:LIMIT]
    return {"counts": counts, "groups": groups,
            "top": {k: v[top] for k, v in groups.items()}}


def _total(v):
    return sum(v) if isinstance(v, (list, tuple)) else v


def group_readings(got: dict, want: dict) -> dict:
    """Every group of the program's group-by against the reference's,
    matched by order key: keys missing or extra, or another date or
    priority, count in `group_key_gap`; `revenue_rel_gap` is the widest
    relative gap of a matched group's revenue."""
    gk = torch.as_tensor(got["l_orderkey"]).long().cpu()
    wk = want["l_orderkey"]
    g_sorted, g_perm = torch.sort(gk)
    w_sorted, w_perm = torch.sort(wk)
    dup = int((g_sorted[1:] == g_sorted[:-1]).sum()) if gk.numel() else 0
    pos = torch.searchsorted(w_sorted, g_sorted).clamp(
        max=max(w_sorted.shape[0] - 1, 0))
    found = (w_sorted[pos] == g_sorted) if wk.numel() else \
        torch.zeros_like(g_sorted, dtype=torch.bool)
    gi, wi = g_perm[found], w_perm[pos[found]]
    missing = wk.numel() - torch.unique(g_sorted[found]).numel()
    key_gap = dup + int((~found).sum()) + missing
    for col in ("o_orderdate", "o_shippriority"):
        key_gap += int((torch.as_tensor(got[col]).long().cpu()[gi]
                        != want[col][wi]).sum())
    rev = rel_gap(torch.as_tensor(got["revenue"]).cpu()[gi],
                  want["revenue"][wi])
    return {"group_key_gap": key_gap, "revenue_rel_gap": rev}


def top_readings(answer: dict, want: dict, groups: dict,
                 limit: float) -> dict:
    """The top rows in order: a row whose order key is not the
    reference's, unless the two rows' revenues tie within `limit`, or
    whose date, priority or revenue differs, counts in `top_gap`."""
    top = want["top"]
    n = len(answer["l_orderkey"])
    gap = abs(n - int(top["l_orderkey"].shape[0]))
    for i in range(min(n, int(top["l_orderkey"].shape[0]))):
        rev_ok = rel_gap([answer["revenue"][i]],
                         [float(top["revenue"][i])]) <= limit
        same_key = int(answer["l_orderkey"][i]) == int(top["l_orderkey"][i])
        date_ok = int(answer["o_orderdate"][i]) == int(top["o_orderdate"][i])
        if not (rev_ok and date_ok and (same_key or _present(
                groups, answer, i, limit))):
            gap += 1
    return {"top_gap": gap}


def _present(groups, answer, i, limit) -> bool:
    """Whether the answer's i-th row is a reference group with its
    revenue (a tie that another order of equal rows would give)."""
    key = int(answer["l_orderkey"][i])
    hit = (groups["l_orderkey"] == key).nonzero().flatten()
    return hit.numel() == 1 and rel_gap(
        [answer["revenue"][i]], [float(groups["revenue"][hit[0]])]) <= limit


def readings(result, want: dict) -> dict:
    """Every number compared for one query (counts summed over shards)."""
    counts = result.counts
    out = {"filter_rows_gap": max(
        count_gap(_total(counts[k]), want["counts"][k])
        for k in ("filter.customer", "filter.orders", "filter.lineitem")),
        "join_rows_gap": max(
        count_gap(_total(counts[k]), want["counts"][k])
        for k in ("join.customer_orders", "join.orders_lineitem"))}
    out.update(group_readings(result.groups, want["groups"]))
    out.update(top_readings(result.answer, want, want["groups"],
                            LIMITS["revenue_rel_gap"]))
    return out
