"""TPC-H Q18 in plain torch, and the comparison of an answer with it.

The reference finds each line item's order by a binary search over the
sorted order keys and sums each order's quantities with index_add, in
`dtype` (float64, the configuration's DECIMAL; float32 for the control);
the orders whose sum passes QUANTITY are the subquery's. Their customers
are looked up by a binary search over the customer keys, and their line
items summed again for the outer group-by. o_totalprice comes from the
line items as the plan's comes (data/totalprice.py: input data, like the
tables), taken in `dtype`. One order is one group of the outer group-by:
its key fixes c_custkey, o_orderdate and o_totalprice.
"""
from __future__ import annotations

import torch

from ..data.totalprice import o_totalprice
from . import count_gap, rel_gap

LIMIT = 100
GROUP_COLUMNS = ("c_custkey", "o_orderkey", "o_orderdate", "o_totalprice",
                 "sum_qty")
HAVING_COLUMNS = ("having.l_orderkey", "having.sum_qty")
# Each reading's limit (PERF.md, section 2). Every count is exact. Sums of
# integer quantities are exact in float64 in any order: an order's is at
# most 7 x 50, the sum over all groups ~1.5e9 at SF 10, far below 2^53.
# The program only carries o_totalprice (joins, a group-by key, a gather),
# so it comes out bit for bit.
LIMITS = {"filter_rows_gap": 0, "join_rows_gap": 0, "group_rows_gap": 0,
          "group_key_gap": 0, "qty_gap": 0, "qty_total_gap": 0,
          "totalprice_rel_gap": 0, "top_gap": 0}


def _lookup(keys: torch.Tensor, want: torch.Tensor) -> tuple:
    """(position in `keys`' own order, found) of each of `want`."""
    s, perm = torch.sort(keys.long())
    w = want.long()
    pos = torch.searchsorted(s, w).clamp(max=max(s.shape[0] - 1, 0))
    return perm[pos], s[pos] == w


def reference(db: dict, params: dict, dtype=torch.float64) -> dict:
    quantity = int(params["QUANTITY"])
    c, o, li = db["customer"], db["orders"], db["lineitem"]
    dev = o["o_orderkey"].device
    n = o["o_orderkey"].shape[0]
    order, found = _lookup(o["o_orderkey"], li["l_orderkey"])
    order = order[found]
    qty = li["l_quantity"][found].to(dtype)
    per_order = torch.zeros(n, dtype=dtype, device=dev).index_add_(
        0, order, qty)
    lines = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, order, torch.ones_like(order))
    big = (lines > 0) & (per_order > quantity)
    _, has_customer = _lookup(c["c_custkey"], o["o_custkey"])
    chosen = big & has_customer
    sel = chosen[order]
    outer = torch.zeros(n, dtype=dtype, device=dev).index_add_(
        0, order[sel], qty[sel])
    idx = torch.nonzero(chosen).flatten()
    hav = torch.nonzero(big).flatten()
    groups = {"c_custkey": o["o_custkey"][idx].long(),
              "o_orderkey": o["o_orderkey"][idx].long(),
              "o_orderdate": o["o_orderdate"][idx].long(),
              "o_totalprice": o_totalprice(db)[idx].to(dtype),
              "sum_qty": outer[idx],
              "having.l_orderkey": o["o_orderkey"][hav].long(),
              "having.sum_qty": per_order[hav],
              "sum_qty_total": qty.sum()}
    return {
        "counts": {"subquery.groups": int((lines > 0).sum()),
                   "having": int(hav.shape[0]),
                   "join.orders": int(hav.shape[0]),
                   "join.customer": int(idx.shape[0]),
                   "join.lineitem": int(sel.sum()),
                   "groups": int(idx.shape[0])},
        "groups": {k: v.cpu() for k, v in groups.items()},
    }


def combine(parts: list) -> dict:
    """The whole query from its chunks' references: counts summed, groups
    concatenated (the total summed), and the first LIMIT groups by
    o_totalprice descending, then o_orderdate (two stable sorts)."""
    counts = {k: sum(p["counts"][k] for p in parts)
              for k in parts[0]["counts"]}
    groups = {k: torch.cat([p["groups"][k] for p in parts])
              for k in GROUP_COLUMNS + HAVING_COLUMNS}
    groups["sum_qty_total"] = sum(p["groups"]["sum_qty_total"]
                                  for p in parts)
    by_date = torch.sort(groups["o_orderdate"], stable=True).indices
    by_price = torch.sort(-groups["o_totalprice"][by_date].double(),
                          stable=True).indices
    top = by_date[by_price][:LIMIT]
    return {"counts": counts, "groups": groups,
            "top": {k: groups[k][top] for k in GROUP_COLUMNS}}


def _match(got_keys, want_keys) -> tuple:
    """Rows of the program's groups matched to the reference's by key:
    (program rows, reference rows, keys duplicated, missing or extra)."""
    gk = torch.as_tensor(got_keys).long().cpu()
    wk = torch.as_tensor(want_keys).long().cpu()
    if wk.numel() == 0:
        return gk[:0], gk[:0], gk.numel()
    g_sorted, g_perm = torch.sort(gk)
    w_sorted, w_perm = torch.sort(wk)
    dup = int((g_sorted[1:] == g_sorted[:-1]).sum()) if gk.numel() else 0
    pos = torch.searchsorted(w_sorted, g_sorted).clamp(
        max=w_sorted.shape[0] - 1)
    found = w_sorted[pos] == g_sorted
    missing = wk.numel() - torch.unique(g_sorted[found]).numel()
    return (g_perm[found], w_perm[pos[found]],
            dup + int((~found).sum()) + missing)


def _col(groups: dict, name: str) -> torch.Tensor:
    return torch.as_tensor(groups[name]).cpu()


def _abs_gap(got, want) -> float:
    got = torch.as_tensor(got, dtype=torch.float64)
    want = torch.as_tensor(want, dtype=torch.float64)
    return float((got - want).abs().max()) if got.numel() else 0.0


def group_readings(got: dict, want: dict) -> dict:
    """The HAVING's rows matched by l_orderkey and every group matched by
    o_orderkey: keys missing, extra or repeated, or a group's c_custkey,
    o_orderdate or o_totalprice not the reference's, count in
    `group_key_gap`; `qty_gap` is the widest gap of a matched sum of
    quantities, `totalprice_rel_gap` of a matched o_totalprice, and
    `qty_total_gap` the gap of the sum over all subquery groups."""
    hg, hw, key_gap = _match(got["having.l_orderkey"],
                             want["having.l_orderkey"])
    qty = _abs_gap(_col(got, "having.sum_qty")[hg],
                   _col(want, "having.sum_qty")[hw])
    gi, wi, gap = _match(got["o_orderkey"], want["o_orderkey"])
    key_gap += gap
    for name in ("c_custkey", "o_orderdate"):
        key_gap += int((_col(got, name).long()[gi]
                        != _col(want, name).long()[wi]).sum())
    price_got = _col(got, "o_totalprice").double()[gi]
    price_want = _col(want, "o_totalprice").double()[wi]
    key_gap += int((price_got != price_want).sum())
    qty = max(qty, _abs_gap(_col(got, "sum_qty")[gi],
                            _col(want, "sum_qty")[wi]))
    return {"group_key_gap": key_gap, "qty_gap": qty,
            "totalprice_rel_gap": rel_gap(price_got, price_want),
            "qty_total_gap": _abs_gap(_col(got, "sum_qty_total"),
                                      _col(want, "sum_qty_total"))}


def top_readings(answer: dict, want: dict) -> dict:
    """The top rows in order: a row whose order key is not the
    reference's at that place, unless its o_totalprice and o_orderdate
    tie with the reference row's and it is a reference group with its
    own values (another order of equal rows), or whose other columns
    differ, counts in `top_gap`."""
    top, groups = want["top"], want["groups"]
    n, m = len(answer["o_orderkey"]), int(top["o_orderkey"].shape[0])
    gap = abs(n - m)
    for i in range(min(n, m)):
        row = {k: answer[k][i] for k in GROUP_COLUMNS}
        tie = (float(row["o_totalprice"]) == float(top["o_totalprice"][i])
               and int(row["o_orderdate"]) == int(top["o_orderdate"][i]))
        same = int(row["o_orderkey"]) == int(top["o_orderkey"][i])
        ref = top if same else groups
        at = i if same else _index(groups["o_orderkey"],
                                   int(row["o_orderkey"]))
        if not tie or at is None or not _equal(row, ref, at):
            gap += 1
    return {"top_gap": gap}


def _index(keys: torch.Tensor, key: int):
    hit = (keys == key).nonzero().flatten()
    return int(hit[0]) if hit.numel() == 1 else None


def _equal(row: dict, ref: dict, at: int) -> bool:
    return all(float(row[k]) == float(ref[k][at]) for k in GROUP_COLUMNS)


def readings(result, want: dict) -> dict:
    """Every number compared for one query. `result.answer` holds numpy
    arrays (the program) or lists (the control)."""
    counts = result.counts
    out = {"filter_rows_gap": count_gap(counts["having"],
                                        want["counts"]["having"]),
           "join_rows_gap": max(
               count_gap(counts[k], want["counts"][k])
               for k in ("join.orders", "join.customer", "join.lineitem")),
           "group_rows_gap": max(
               count_gap(counts[k], want["counts"][k])
               for k in ("subquery.groups", "groups"))}
    out.update(group_readings(result.groups, want["groups"]))
    out.update(top_readings(result.answer, want))
    return out
