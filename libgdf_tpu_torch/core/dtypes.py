"""Column type system: GDF logical dtypes mapped onto torch dtypes.

Counterpart of `libgdf_tpu/core/dtypes.py` (reference: libgdf/include/gdf/
cffi/types.h:15-29 `gdf_dtype`, types.h:71-82 `gdf_time_unit`). The enum
values are the reference ABI's; tests/test_torch_core.py pins them to the
JAX package's.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch


class GDFDtype(enum.IntEnum):
    """Logical column dtypes (values match types.h:15-29)."""

    invalid = 0
    INT8 = 1
    INT16 = 2
    INT32 = 3
    INT64 = 4
    FLOAT32 = 5
    FLOAT64 = 6
    DATE32 = 7       # int32 days since UNIX epoch
    DATE64 = 8       # int64 milliseconds since UNIX epoch
    TIMESTAMP = 9    # int64 since UNIX epoch, unit in TimeUnit
    CATEGORY = 10    # int32 dictionary indices
    STRING = 11      # not device-resident; dictionary-encoded via CATEGORY


class TimeUnit(enum.IntEnum):
    """types.h:71-77 `gdf_time_unit`."""

    NONE = 0
    s = 1
    ms = 2
    us = 3
    ns = 4


# Physical torch dtype backing each logical dtype.
_PHYSICAL = {
    GDFDtype.INT8: torch.int8,
    GDFDtype.INT16: torch.int16,
    GDFDtype.INT32: torch.int32,
    GDFDtype.INT64: torch.int64,
    GDFDtype.FLOAT32: torch.float32,
    GDFDtype.FLOAT64: torch.float64,
    GDFDtype.DATE32: torch.int32,
    GDFDtype.DATE64: torch.int64,
    GDFDtype.TIMESTAMP: torch.int64,
    GDFDtype.CATEGORY: torch.int32,
}

# Default logical dtype for a raw numpy dtype (as in the JAX package).
_FROM_NUMPY = {
    np.dtype(np.int8): GDFDtype.INT8,
    np.dtype(np.int16): GDFDtype.INT16,
    np.dtype(np.int32): GDFDtype.INT32,
    np.dtype(np.int64): GDFDtype.INT64,
    np.dtype(np.float32): GDFDtype.FLOAT32,
    np.dtype(np.float64): GDFDtype.FLOAT64,
    np.dtype(np.uint8): GDFDtype.INT8,
    np.dtype(np.uint32): GDFDtype.INT32,
    np.dtype(np.uint64): GDFDtype.INT64,
    np.dtype(np.bool_): GDFDtype.INT8,
}

_FROM_TORCH = {
    torch.int8: GDFDtype.INT8,
    torch.int16: GDFDtype.INT16,
    torch.int32: GDFDtype.INT32,
    torch.int64: GDFDtype.INT64,
    torch.float32: GDFDtype.FLOAT32,
    torch.float64: GDFDtype.FLOAT64,
    torch.uint8: GDFDtype.INT8,
    torch.bool: GDFDtype.INT8,
}


@dataclass(frozen=True)
class DtypeInfo:
    """Logical dtype + extra info (≅ gdf_dtype + gdf_dtype_extra_info,
    types.h:79-82)."""

    gdf_dtype: GDFDtype
    time_unit: TimeUnit = TimeUnit.NONE

    @property
    def physical(self) -> torch.dtype:
        return _PHYSICAL[self.gdf_dtype]


def dtype_from_numpy(dt) -> GDFDtype:
    """Infer the logical dtype for a numpy dtype or a torch dtype."""
    if isinstance(dt, torch.dtype):
        table, key = _FROM_TORCH, dt
    else:
        table, key = _FROM_NUMPY, np.dtype(dt)
    try:
        return table[key]
    except KeyError:
        raise TypeError(f"unsupported dtype for GDF column: {dt}") from None


def physical_dtype(gdf_dtype: GDFDtype) -> torch.dtype:
    return _PHYSICAL[gdf_dtype]
