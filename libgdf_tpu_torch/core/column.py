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

from .bitmask import pack_bool_mask, unpack_bitmask
from .dtypes import DtypeInfo, GDFDtype, TimeUnit, dtype_from_numpy, physical_dtype
from .errors import GDFError, GDFStatus
from ..utils.tracing import host_sync


def host_data_device(device=None) -> torch.device:
    """Where host (numpy) data goes: `device` if given, else the card. With
    no CUDA device and no `device`, raises instead of choosing the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise GDFError(GDFStatus.GDF_CUDA_ERROR,
                       "no CUDA device for host data; pass device='cpu' to "
                       "build the column on the CPU")
    return torch.device("cuda")


def as_tensor(x, device=None, dtype: torch.dtype | None = None) -> torch.Tensor:
    """numpy array / sequence / tensor -> tensor on `device`. With `device`
    None a tensor stays where it is and host data goes to the card
    (host_data_device)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    arr = np.asarray(x)
    if dtype is not None:
        np_dt = torch.empty((), dtype=dtype).numpy().dtype
        arr = arr.astype(np_dt, copy=False)
    if not arr.flags.writeable:
        arr = arr.copy()    # a CPU tensor would share the read-only buffer
    return torch.as_tensor(np.ascontiguousarray(arr),
                           device=host_data_device(device))


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
        be a bool array, a packed uint8 Arrow bitmask, or None. numpy data
        goes to `device`, by default the card (raises where there is none:
        pass device="cpu"); a tensor stays on its device unless `device` is
        given. `valid` follows the data."""
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
        """Convenience: `null_mask[i]=True` means row i is NULL. Devices as
        in from_array."""
        if device is None and isinstance(values, torch.Tensor):
            device = values.device
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

    @property
    def gdf_dtype(self) -> GDFDtype:
        return self.info.gdf_dtype

    @property
    def has_nulls(self) -> bool:
        """Structural: whether a validity mask is attached (not whether any
        bit is actually 0: that would force a sync)."""
        return self.valid is not None

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

    # -- interchange ---------------------------------------------------------

    def packed_bitmask(self) -> Optional[torch.Tensor]:
        """Arrow-layout packed validity (interchange; core/bitmask.py)."""
        if self.valid is None:
            return None
        return pack_bool_mask(self.valid)

    def to_numpy_masked(self):
        """Return (values: np.ndarray, null_mask: np.ndarray bool); copies
        to the host, so it syncs."""
        with host_sync("column.to_numpy"):
            vals = self.data.cpu().numpy()
            nulls = (np.zeros(self.size, bool) if self.valid is None
                     else ~self.valid.cpu().numpy())
        return vals, nulls


def column_concat(columns) -> Column:
    """Concatenate columns of identical dtype, merging validity.

    ≅ gdf_column_concat (src/column.cpp:53-153): the output has a mask iff
    any input does."""
    columns = list(columns)
    if not columns:
        raise GDFError(GDFStatus.GDF_DATASET_EMPTY, "concat of zero columns")
    info = columns[0].info
    for c in columns[1:]:
        if c.info.gdf_dtype != info.gdf_dtype:
            raise GDFError(GDFStatus.GDF_DTYPE_MISMATCH,
                           "concat dtype mismatch")
    data = torch.cat([c.data for c in columns])
    if any(c.valid is not None for c in columns):
        valid = torch.cat([c.valid_or_true() for c in columns])
    else:
        valid = None
    return Column(data=data, valid=valid, info=info, name=columns[0].name)
