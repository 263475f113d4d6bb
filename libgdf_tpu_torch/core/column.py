"""Column: one tensor of values plus an optional bool validity tensor.

Counterpart of `libgdf_tpu/core/column.py` (≅ reference `gdf_column`,
libgdf/include/gdf/cffi/types.h:84-92), as a plain frozen dataclass:

  - `data`  — a 1-D tensor on any device
  - `valid` — optional bool tensor of the same length; None = no nulls
  - `info`  — DtypeInfo (logical dtype + time unit)
  - `name`  — column name

Validity stays unpacked (one bool per row); the packed Arrow bitmask is an
interchange format only (core/bitmask.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np
import torch

from .bitmask import unpack_bitmask
from .dtypes import DtypeInfo, GDFDtype, TimeUnit, dtype_from_numpy, physical_dtype
from .errors import GDFError, GDFStatus


def as_tensor(x, device=None, dtype: torch.dtype | None = None) -> torch.Tensor:
    """numpy array / sequence / tensor -> tensor on `device` (None keeps a
    tensor where it is and puts host data on the CPU)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    arr = np.asarray(x)
    if dtype is not None:
        np_dt = torch.empty((), dtype=dtype).numpy().dtype
        arr = arr.astype(np_dt, copy=False)
    return torch.as_tensor(np.ascontiguousarray(arr), device=device)


@dataclass(frozen=True)
class Column:
    data: torch.Tensor
    valid: Optional[torch.Tensor] = None
    info: DtypeInfo = field(default=DtypeInfo(GDFDtype.invalid))
    name: str = ""

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_array(data, valid=None, gdf_dtype: GDFDtype | None = None,
                   time_unit: TimeUnit = TimeUnit.NONE, name: str = "",
                   device=None) -> "Column":
        """Build a Column from numpy data or a tensor.

        ≅ gdf_column_view[_augmented] (src/column.cpp:175-214). `valid` may
        be a bool array, a packed uint8 Arrow bitmask, or None."""
        if gdf_dtype is None:
            src_dt = (data.dtype if isinstance(data, torch.Tensor)
                      else np.asarray(data).dtype)
            gdf_dtype = dtype_from_numpy(src_dt)
        info = DtypeInfo(gdf_dtype, time_unit)
        data = as_tensor(data, device, physical_dtype(gdf_dtype))
        if data.dim() != 1:
            raise GDFError(GDFStatus.GDF_INVALID_API_CALL, "columns are 1-D")
        if valid is not None:
            valid = as_tensor(valid, data.device)
            if valid.dtype == torch.uint8 and valid.shape[0] != data.shape[0]:
                valid = unpack_bitmask(valid, data.shape[0])
            else:
                valid = valid.to(torch.bool)
            if valid.shape[0] != data.shape[0]:
                raise GDFError(GDFStatus.GDF_COLUMN_SIZE_MISMATCH,
                               "validity mask length != column length")
        return Column(data=data, valid=valid, info=info, name=name)

    @staticmethod
    def from_masked(values, null_mask=None, name: str = "",
                    gdf_dtype: GDFDtype | None = None,
                    device=None) -> "Column":
        """Convenience: `null_mask[i]=True` means row i is NULL."""
        valid = None
        if null_mask is not None:
            valid = ~as_tensor(null_mask, device, torch.bool)
        return Column.from_array(values, valid=valid, name=name,
                                 gdf_dtype=gdf_dtype, device=device)

    # -- introspection -------------------------------------------------------

    @property
    def size(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def null_count(self) -> torch.Tensor:
        """0-d device count of NULL rows."""
        if self.valid is None:
            return torch.zeros((), dtype=torch.int32, device=self.device)
        return (~self.valid).sum(dtype=torch.int32)

    def valid_or_true(self) -> torch.Tensor:
        if self.valid is None:
            return torch.ones(self.size, dtype=torch.bool, device=self.device)
        return self.valid

    # -- functional updates --------------------------------------------------

    def with_data(self, data, info: DtypeInfo | None = None) -> "Column":
        return replace(self, data=data, info=info or self.info)

    def with_valid(self, valid) -> "Column":
        return replace(self, valid=valid)

    def with_name(self, name: str) -> "Column":
        return replace(self, name=name)
