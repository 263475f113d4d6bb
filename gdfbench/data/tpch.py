"""TPC-H tables on the device, from a seed (TPC-H specification, clause 4.2.3).

Only the columns that the benchmark's queries read are made; each is a
plain tensor, so the reference and the program are handed the same
inputs. Every table is made in a few large torch calls from a
`torch.Generator` on the target device, seeded from (seed, table, chunk):
the same seed, scale factor and chunking give the same tables.

Chunking follows `dbgen -C <chunks> -S <chunk + 1>`: chunk r holds the
orders of the r-th key range with all their line items, and the r-th range
of customers. The chunks of one chunking together hold every key exactly
once.

Encodings (the configuration's `assumed`): DECIMAL(15,2) as float64,
identifiers and dates (DATE32, days since 1970-01-01) as int32, flags and
segments as int8 dictionary codes whose order is the strings' order.
"""
from __future__ import annotations

import hashlib

import torch

ORDERS_PER_SF = 1_500_000
CUSTOMERS_PER_SF = 150_000
PARTS_PER_SF = 200_000

START_DATE = 8035            # 1992-01-01
ORDER_DATE_MAX = 10440       # 1998-08-02: ENDDATE - 151 days
CURRENT_DATE = 9298          # 1995-06-17
MAX_SHIP_DAYS = 121
MAX_RECEIPT_DAYS = 30
MAX_LINES = 7

SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
RETURNFLAGS = ("A", "N", "R")
LINESTATUS = ("F", "O")
FLAG_A, FLAG_N, FLAG_R = 0, 1, 2

TABLES = ("customer", "orders", "lineitem")


def table_rows(table: str, sf: float) -> int:
    """Rows of the whole customer or orders table at scale factor `sf`."""
    per = {"customer": CUSTOMERS_PER_SF, "orders": ORDERS_PER_SF}[table]
    return int(round(sf * per))


def chunk_range(total: int, chunk: int, chunks: int) -> tuple:
    """[lo, hi) of the chunk-th of `chunks` equal key ranges of `total`."""
    return total * chunk // chunks, total * (chunk + 1) // chunks


def table_seed(seed: int, table: str, chunk: int, chunks: int) -> int:
    """A 63-bit generator seed for one chunk of one table."""
    h = hashlib.sha256(f"tpch:{seed}:{table}:{chunk}/{chunks}".encode())
    return int.from_bytes(h.digest()[:8], "little") & ((1 << 63) - 1)


def _generator(seed, table, chunk, chunks, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(table_seed(seed, table, chunk, chunks))
    return g


def _randint(g, low, high, n, dtype, device):
    """n draws, uniform on [low, high] (both ends included)."""
    return torch.randint(low, high + 1, (n,), generator=g, dtype=dtype,
                         device=device)


def orderkeys(index: torch.Tensor) -> torch.Tensor:
    """dbgen's sparse order keys: the first 8 of each 32 (int64 in, out)."""
    return (index // 8) * 32 + index % 8 + 1


def customer_keys_not_div3(m: torch.Tensor) -> torch.Tensor:
    """The m-th (0-based) positive integer not divisible by 3."""
    return m + m // 2 + 1


def retail_cents(partkey: torch.Tensor) -> torch.Tensor:
    """p_retailprice in cents (clause 4.2.3): 90000 + (partkey / 10 mod
    20001) + 100 (partkey mod 1000)."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def customer(sf, seed, chunk=0, chunks=1, device="cpu") -> dict:
    lo, hi = chunk_range(table_rows("customer", sf), chunk, chunks)
    g = _generator(seed, "customer", chunk, chunks, device)
    return {
        "c_custkey": torch.arange(lo + 1, hi + 1, dtype=torch.int32,
                                  device=device),
        "c_mktsegment": _randint(g, 0, len(SEGMENTS) - 1, hi - lo,
                                 torch.int8, device),
    }


def orders_and_lineitem(sf, seed, chunk=0, chunks=1, device="cpu") -> tuple:
    """(orders, lineitem) of one chunk: the orders of its key range and
    all their line items."""
    lo, hi = chunk_range(table_rows("orders", sf), chunk, chunks)
    n = hi - lo
    g = _generator(seed, "orders", chunk, chunks, device)
    index = torch.arange(lo, hi, dtype=torch.int64, device=device)
    ncust = table_rows("customer", sf)
    cust = customer_keys_not_div3(
        _randint(g, 0, ncust - ncust // 3 - 1, n, torch.int64, device))
    orderdate = _randint(g, START_DATE, ORDER_DATE_MAX, n, torch.int32,
                         device)
    orders = {
        "o_orderkey": orderkeys(index).to(torch.int32),
        "o_custkey": cust.to(torch.int32),
        "o_orderdate": orderdate,
        "o_shippriority": torch.zeros(n, dtype=torch.int32, device=device),
    }

    g = _generator(seed, "lineitem", chunk, chunks, device)
    lines = _randint(g, 1, MAX_LINES, n, torch.int64, device)
    total = int(lines.sum())
    order = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int64, device=device), lines,
        output_size=total)
    qty = _randint(g, 1, 50, total, torch.int64, device)
    nparts = max(1, int(round(sf * PARTS_PER_SF)))
    partkey = _randint(g, 1, nparts, total, torch.int64, device)
    price_cents = qty * retail_cents(partkey)
    discount = _randint(g, 0, 10, total, torch.int64, device)
    tax = _randint(g, 0, 8, total, torch.int64, device)
    shipdate = orderdate[order] + _randint(g, 1, MAX_SHIP_DAYS, total,
                                           torch.int32, device)
    receipt = shipdate + _randint(g, 1, MAX_RECEIPT_DAYS, total,
                                  torch.int32, device)
    r_or_a = torch.where(_randint(g, 0, 1, total, torch.int8, device) == 0,
                         FLAG_R, FLAG_A).to(torch.int8)
    lineitem = {
        "l_orderkey": orders["o_orderkey"][order],
        "l_quantity": qty.to(torch.float64),
        "l_extendedprice": price_cents.to(torch.float64) / 100,
        "l_discount": discount.to(torch.float64) / 100,
        "l_tax": tax.to(torch.float64) / 100,
        "l_returnflag": torch.where(receipt <= CURRENT_DATE, r_or_a,
                                    FLAG_N).to(torch.int8),
        "l_linestatus": (shipdate > CURRENT_DATE).to(torch.int8),
        "l_shipdate": shipdate,
    }
    return orders, lineitem


def generate(sf, seed, chunk=0, chunks=1, device="cpu") -> dict:
    """{table: {column: tensor}} of one chunk, on `device`."""
    orders, lineitem = orders_and_lineitem(sf, seed, chunk, chunks, device)
    return {"customer": customer(sf, seed, chunk, chunks, device),
            "orders": orders, "lineitem": lineitem}


def pad_rows(table: dict, capacity: int) -> dict:
    """Every column zero-padded to `capacity` rows."""
    out = {}
    for name, col in table.items():
        pad = capacity - col.shape[0]
        out[name] = col if pad == 0 else torch.cat([col, col.new_zeros(pad)])
    return out
