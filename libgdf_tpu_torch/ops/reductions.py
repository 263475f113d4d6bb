"""Reductions: sum / min / max / product / sum_of_squares over nullable
columns.

Counterpart of `libgdf_tpu/ops/reductions.py` (≅ libgdf/src/reductions.cu:
24-200 and gdf_sum / gdf_min / gdf_max / gdf_product / gdf_sum_squared,
functions.h). NULL rows are replaced by the op's identity, then one torch
reduction runs, as the JAX package leaves it to one XLA reduction. Result
dtypes are the JAX package's: integer sums and products in int64 (the
square of sum_of_squares is taken in the column's dtype first, as there),
min and max in the column's dtype, floats in their own dtype. A float
denormal is zero on every reduction's input, as XLA reads it
(core/bits.py::flush_denormals): 300 float32 1e-40 sum to 0, not to the
normal 3e-38, and [1e-40, 1e30] multiply to 0, not to 1e-10. The sums
pay one flush pass before torch's reduction (sum_of_squares flushes the
squares, which covers a denormal input: its square underflows to zero).
Float min and max also order -0.0 below +0.0, as XLA does. Results are
0-d tensors on the column's device; nothing here syncs. The min or max
of an empty column raises GDFError.

`num_rows`, where given, is the live count of the table the column came
from (`Table.num_rows`, a 0-d device tensor; core/table.py): rows at or
past it are dead, whatever they hold, and enter as the op's identity in
the same `torch.where` that masks NULL rows, so the count is never read
on the host. A reduction over no live rows gives the identity then, for
min and max too (raising would take a host read). Each call is counted
(`reduce`, and `reduce.rows` the capacity it read) in
`utils.tracing.counters()` and runs inside the span `libgdf.op.reduce`.
"""
from __future__ import annotations

import math

import torch

from ..core.bits import flush_denormals
from ..core.column import Column
from ..core.errors import GDFStatus, require
from ..core.table import live_rows
from ..utils.tracing import count, spanned

GDF_REDUCE_OPTIMAL_OUTPUT_SIZE = 128  # functions.h:632, ABI parity only


def _identity(op: str, dtype: torch.dtype):
    if op == "sum":
        return 0
    if op == "product":
        return 1
    if dtype.is_floating_point:
        return math.inf if op == "min" else -math.inf
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


@spanned("libgdf.op.reduce")
def reduce(col: Column, op: str, num_rows=None) -> torch.Tensor:
    """Reduce a column to a 0-d tensor, skipping NULL rows (≅
    reductions.cu:37-45) and, with `num_rows`, the rows at or past it."""
    require(op in ("sum", "min", "max", "product", "sum_squared"),
            GDFStatus.GDF_INVALID_AGGREGATOR, op)
    x = col.data
    count("reduce")
    count("reduce.rows", x.shape[0])
    if op == "sum_squared":
        x = x * x            # squared on load, ≅ DeviceSumSquared :151-166
        op = "sum"
    x = flush_denormals(x)
    keep = col.valid
    if num_rows is not None:
        live = live_rows(x.shape[0], num_rows, x.device)
        keep = live if keep is None else keep & live
    if keep is not None:
        x = torch.where(keep, x, _identity(op, x.dtype))
    wide = None if x.is_floating_point() else torch.int64
    if op == "sum":
        return torch.sum(x, dtype=wide)
    if op == "product":
        return torch.prod(x, dtype=wide)
    if num_rows is not None and x.shape[0] == 0:
        return torch.full((), _identity(op, x.dtype), dtype=x.dtype,
                          device=x.device)
    require(x.shape[0] > 0, GDFStatus.GDF_DATASET_EMPTY,
            f"{op} of an empty column")
    if not x.is_floating_point():
        return torch.amin(x) if op == "min" else torch.amax(x)
    out = torch.amin(x) if op == "min" else torch.amax(x)
    # torch leaves the sign of a zero result to the order of the rows
    zero = x == 0
    if op == "min":
        signed = torch.where((zero & torch.signbit(x)).any(), -0.0, 0.0)
    else:
        signed = torch.where((zero & ~torch.signbit(x)).any(), 0.0, -0.0)
    return torch.where(out == 0, signed.to(out.dtype), out)


def sum(col: Column, num_rows=None):
    return reduce(col, "sum", num_rows)


def min(col: Column, num_rows=None):
    return reduce(col, "min", num_rows)


def max(col: Column, num_rows=None):
    return reduce(col, "max", num_rows)


def product(col: Column, num_rows=None):
    return reduce(col, "product", num_rows)


def sum_of_squares(col: Column, num_rows=None):
    return reduce(col, "sum_squared", num_rows)

