"""O_TOTALPRICE from the generated line items (TPC-H specification, clause
4.2.3), in plain torch on the tables' device.

The column is input data, made in set-up like the tables: the plan's
`prepare` and the reference each call `o_totalprice`. dbgen's mk_order
sums, over the order's lines, each line's charge in integer cents,

    ep_cents * (100 - discount) // 100 * (100 + tax) // 100

with the discount and the tax in whole percent and C's truncating
division, evaluated left to right (the configuration lists the term under
`assumed`). The line items carry l_extendedprice, l_discount and l_tax as
float64 cents / 100 and percent / 100, so each is turned back into its
integer exactly by rounding.
"""
from __future__ import annotations

import torch


def line_charge_cents(extendedprice: torch.Tensor, discount: torch.Tensor,
                      tax: torch.Tensor) -> torch.Tensor:
    """Each line's term of O_TOTALPRICE, int64 cents."""
    ep = torch.round(extendedprice * 100).to(torch.int64)
    disc = torch.round(discount * 100).to(torch.int64)
    tx = torch.round(tax * 100).to(torch.int64)
    return ep * (100 - disc) // 100 * (100 + tx) // 100


def o_totalprice(db: dict) -> torch.Tensor:
    """float64 O_TOTALPRICE of each row of `db["orders"]`, from the line
    items of `db["lineitem"]` (each order's lines lie in its chunk); an
    order with no line would be 0."""
    o, li = db["orders"], db["lineitem"]
    keys, perm = torch.sort(o["o_orderkey"].long())
    pos = torch.searchsorted(keys, li["l_orderkey"].long())
    cents = torch.zeros(keys.shape[0], dtype=torch.int64, device=keys.device)
    cents.index_add_(0, perm[pos], line_charge_cents(
        li["l_extendedprice"], li["l_discount"], li["l_tax"]))
    return cents.to(torch.float64) / 100
