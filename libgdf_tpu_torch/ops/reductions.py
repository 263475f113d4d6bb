"""Reductions: sum / min / max / product / sum_of_squares over nullable
columns.

Counterpart of `libgdf_tpu/ops/reductions.py` (≅ libgdf/src/reductions.cu:
24-200 and gdf_sum / gdf_min / gdf_max / gdf_product / gdf_sum_squared,
functions.h). NULL rows are replaced by the op's identity, then one torch
reduction runs, as the JAX package leaves it to one XLA reduction. Result
dtypes are the JAX package's: integer sums and products in int64 (the
square of sum_of_squares is taken in the column's dtype first, as there),
min and max in the column's dtype, floats in their own dtype. Float min
and max are XLA's: a denormal is zero (core/bits.py::flush_denormals) and
-0.0 orders below +0.0. Results are 0-d tensors on the column's device;
nothing here syncs. The min or max of an empty column raises GDFError.
"""
from __future__ import annotations

import math

import torch

from ..core.bits import flush_denormals
from ..core.column import Column
from ..core.errors import GDFStatus, require

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


def reduce(col: Column, op: str) -> torch.Tensor:
    """Reduce a column to a 0-d tensor, skipping NULL rows (≅
    reductions.cu:37-45)."""
    require(op in ("sum", "min", "max", "product", "sum_squared"),
            GDFStatus.GDF_INVALID_AGGREGATOR, op)
    x = col.data
    if op == "sum_squared":
        x = x * x            # squared on load, ≅ DeviceSumSquared :151-166
        op = "sum"
    if col.valid is not None:
        x = torch.where(col.valid, x, _identity(op, x.dtype))
    wide = None if x.is_floating_point() else torch.int64
    if op == "sum":
        return torch.sum(x, dtype=wide)
    if op == "product":
        return torch.prod(x, dtype=wide)
    require(x.shape[0] > 0, GDFStatus.GDF_DATASET_EMPTY,
            f"{op} of an empty column")
    if not x.is_floating_point():
        return torch.amin(x) if op == "min" else torch.amax(x)
    x = flush_denormals(x)
    out = torch.amin(x) if op == "min" else torch.amax(x)
    # torch leaves the sign of a zero result to the order of the rows
    zero = x == 0
    if op == "min":
        signed = torch.where((zero & torch.signbit(x)).any(), -0.0, 0.0)
    else:
        signed = torch.where((zero & ~torch.signbit(x)).any(), 0.0, -0.0)
    return torch.where(out == 0, signed.to(out.dtype), out)


def sum(col: Column):
    return reduce(col, "sum")


def min(col: Column):
    return reduce(col, "min")


def max(col: Column):
    return reduce(col, "max")


def product(col: Column):
    return reduce(col, "product")


def sum_of_squares(col: Column):
    return reduce(col, "sum_squared")

