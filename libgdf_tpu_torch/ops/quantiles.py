"""Quantiles: exact and approximate.

Counterpart of `libgdf_tpu/ops/quantiles.py` (≅ gdf_quantile_exact,
libgdf/src/quantiles.cu:83-244, include/quantiles.hpp:32-158, and
gdf_quantile_aprrox, functions.h:782). One stable sort of (NULL flag,
value) puts NULL rows last; the quantile is read at q * (n_valid - 1).
A denormal is zero where XLA reads it so: a float32 value is flushed
before it is widened to float64 (float32 [1e-40, 2e-40, 3e-40, 5e-40]
has median 0.0, not 2.5e-40), and `linear` / `midpoint` flush the values
they combine; `lower` / `higher` / `nearest` of a float64 column return
the value as stored, as the reference's gather does.
Results are 0-d tensors on the column's device; nothing here syncs. A
quantile of an empty column raises GDFError.
"""
from __future__ import annotations

import torch

from ..core.bits import flush_denormals, to_float64
from ..core.column import Column
from ..core.errors import GDFStatus, require
from .engine import multi_sort

METHODS = ("linear", "lower", "higher", "midpoint", "nearest")


def _sorted_valid(col: Column):
    """(values sorted with NULL rows last, number of valid rows)."""
    require(col.size > 0, GDFStatus.GDF_DATASET_EMPTY,
            "quantile of an empty column")
    flag = (torch.zeros(col.size, dtype=torch.uint8, device=col.device)
            if col.valid is None else (~col.valid).to(torch.uint8))
    _, svals = multi_sort([flag, col.data], num_keys=2)
    return svals, (flag == 0).sum(dtype=torch.int32)


def _position(q: float, n_valid: torch.Tensor) -> torch.Tensor:
    return q * (n_valid.clamp(min=1) - 1).to(torch.float64)


def quantile_exact(col: Column, q: float, method: str = "linear"):
    """Exact quantile of a (possibly nullable) column, a float64 0-d
    tensor; q in [0, 1]. `nearest` rounds half to even, as numpy does."""
    require(method in METHODS, GDFStatus.GDF_INVALID_API_CALL, method)
    require(0.0 <= q <= 1.0, GDFStatus.GDF_INVALID_API_CALL,
            "q outside [0,1]")
    svals, n = _sorted_valid(col)
    pos = _position(q, n)
    if method == "nearest":
        return to_float64(svals[torch.round(pos).to(torch.int64)])
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.ceil(pos).to(torch.int64)
    vlo = to_float64(svals[lo])
    vhi = to_float64(svals[hi])
    if method in ("linear", "midpoint"):
        vlo, vhi = flush_denormals(vlo), flush_denormals(vhi)
    if method == "linear":
        return vlo + (vhi - vlo) * (pos - lo)
    if method == "lower":
        return vlo
    if method == "higher":
        return vhi
    return (vlo + vhi) * 0.5


def quantile_approx(col: Column, q: float):
    """≅ gdf_quantile_aprrox (functions.h:782): the value at the lower
    position, in the column's own dtype (0-d tensor)."""
    svals, n = _sorted_valid(col)
    return svals[_position(q, n).to(torch.int64)]
