"""Prefix sums (scan).

Counterpart of `libgdf_tpu/ops/scan.py` (≅ gdf_prefixsum_*, libgdf/src/
scan.cu:11-76, via cub::DeviceScan). Like the reference, no validity
support. Lowers through engine.cumsum: on the card, H2 at the column's
dtype (int64 and float64 are the Hopper form of the TPU's K4a and K5a).
"""
from __future__ import annotations

import torch

from ..core.column import Column
from ..core.errors import GDFError, GDFStatus
from . import engine


def prefixsum(col: Column, inclusive: bool = True) -> Column:
    """Inclusive (default) or exclusive prefix sum, in the column's dtype.
    An exclusive sum is the inclusive one shifted down by one row; an
    empty column gives an empty column."""
    if col.valid is not None:
        # scan.cu has no validity handling; reject rather than guess.
        raise GDFError(GDFStatus.GDF_VALIDITY_UNSUPPORTED,
                       "prefixsum does not support validity masks")
    x = col.data
    s = engine.cumsum(x, x.dtype)
    if not inclusive and s.shape[0]:
        s = torch.cat([torch.zeros(1, dtype=s.dtype, device=s.device),
                       s[:-1]])
    return col.with_data(s)
