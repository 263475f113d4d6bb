"""Comparisons producing INT8 stencil columns, with null propagation.

Counterpart of `compare_scalar` and `compare` in
`libgdf_tpu/ops/elementwise.py` (≅ libgdf/src/filterops.cu:17-95,
162-260): the output is 1 where the comparison holds, and its validity is
the input's (column vs scalar) or both inputs' (column vs column).
"""
from __future__ import annotations

import torch

from ..core.bitmask import mask_and
from ..core.column import Column
from ..core.dtypes import DtypeInfo, GDFDtype
from ..core.errors import GDFStatus, require

_CMP = {
    "gt": torch.gt, "ge": torch.ge, "lt": torch.lt, "le": torch.le,
    "eq": torch.eq, "ne": torch.ne,
}

_CMP_ENUM = {  # gdf_comparison_operator, types.h:188-195
    0: "eq", 1: "ne", 2: "lt", 3: "le", 4: "gt", 5: "ge",
    "eq": "eq", "ne": "ne", "lt": "lt", "le": "le", "gt": "gt", "ge": "ge",
}

_INT8 = DtypeInfo(GDFDtype.INT8)


def compare_scalar(col: Column, value, op) -> Column:
    """column OP scalar -> INT8 stencil column (1 = pass).

    ≅ gpu_comparison_static_* (filterops.cu:17-95). An integer column
    compared with a float scalar compares in float64, as the JAX package's
    promotion does; otherwise the scalar takes the column's dtype."""
    op = _CMP_ENUM[op]
    data = col.data
    if isinstance(value, float) and not data.is_floating_point():
        data = data.to(torch.float64)
    out = _CMP[op](data, value).to(torch.int8)
    return Column(data=out, valid=col.valid, info=_INT8, name=col.name)


def compare(a: Column, b: Column, op) -> Column:
    """column OP column -> INT8 stencil; valid where both inputs are
    (≅ gpu_comparison, filterops.cu:162-260)."""
    op = _CMP_ENUM[op]
    require(a.size == b.size, GDFStatus.GDF_COLUMN_SIZE_MISMATCH)
    out = _CMP[op](a.data, b.data).to(torch.int8)
    return Column(data=out, valid=mask_and(a.valid, b.valid), info=_INT8,
                  name=a.name)
