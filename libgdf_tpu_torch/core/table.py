"""Table: an ordered set of equal-length Columns.

Counterpart of `libgdf_tpu/core/table.py` (≅ reference `gdf_table`,
libgdf/src/gdf_table.cuh:241-1363). Keeps the **capacity + count**
convention: operators with data-dependent output sizes (filter, join,
groupby) return columns of a fixed capacity plus `num_rows`, a 0-d int32
tensor on the columns' device. Rows past `num_rows` are dead and their
contents are unspecified. `num_rows=None` means every row is live.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence

import torch

from .bitmask import mask_and
from .column import Column
from .errors import GDFStatus, require


def _count_tensor(num_rows, device) -> Optional[torch.Tensor]:
    if num_rows is None:
        return None
    if isinstance(num_rows, torch.Tensor):
        return num_rows.to(device=device, dtype=torch.int32).reshape(())
    return torch.tensor(int(num_rows), dtype=torch.int32, device=device)


@dataclass(frozen=True)
class Table:
    columns: tuple  # tuple[Column, ...]
    num_rows: Optional[torch.Tensor] = None
    names: tuple = ()

    # -- construction --------------------------------------------------------

    @staticmethod
    def from_columns(columns: Sequence[Column], num_rows=None) -> "Table":
        columns = tuple(columns)
        require(len(columns) > 0, GDFStatus.GDF_DATASET_EMPTY,
                "table with zero columns")
        n = columns[0].size
        for c in columns:
            require(c.size == n, GDFStatus.GDF_COLUMN_SIZE_MISMATCH,
                    f"column {c.name!r} has {c.size} rows, expected {n}")
        names = tuple(c.name if c.name else f"c{i}"
                      for i, c in enumerate(columns))
        return Table(columns=columns,
                     num_rows=_count_tensor(num_rows, columns[0].device),
                     names=names)

    @staticmethod
    def from_dict(data: dict, nulls: dict | None = None,
                  device=None) -> "Table":
        """data: {name: numpy array or tensor}; nulls: {name: bool null-mask}
        (True = NULL). Tensors stay on their device unless `device` is
        given; numpy data goes to `device` (default: the CPU)."""
        nulls = nulls or {}
        cols = [Column.from_masked(v, nulls.get(k), name=k, device=device)
                for k, v in data.items()]
        return Table.from_columns(cols)

    # -- introspection -------------------------------------------------------

    @property
    def capacity(self) -> int:
        """Row capacity (tensor length)."""
        return self.columns[0].size

    @property
    def device(self) -> torch.device:
        return self.columns[0].device

    def column(self, name: str) -> Column:
        try:
            return self.columns[self.names.index(name)]
        except ValueError:
            raise KeyError(name) from None

    def __getitem__(self, name: str) -> Column:
        return self.column(name)

    def with_num_rows(self, num_rows) -> "Table":
        return replace(self, num_rows=_count_tensor(num_rows, self.device))

    def to(self, device) -> "Table":
        """The same table with every tensor on `device`."""
        cols = tuple(replace(c, data=c.data.to(device),
                             valid=None if c.valid is None
                             else c.valid.to(device))
                     for c in self.columns)
        return replace(self, columns=cols,
                       num_rows=_count_tensor(self.num_rows, device))

    # -- row machinery -------------------------------------------------------

    def live_mask(self) -> torch.Tensor:
        """bool[capacity]: True for rows < num_rows."""
        iota = torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device)
        if self.num_rows is None:
            return torch.ones_like(iota, dtype=torch.bool)
        return iota < self.num_rows

    def row_validity(self) -> torch.Tensor:
        """Row is valid iff valid in EVERY column (and live).

        ≅ gdf_table's row bitmask (gdf_table.cuh:62-98, 310-318)."""
        m = None
        for c in self.columns:
            m = mask_and(m, c.valid)
        if self.num_rows is not None:
            m = mask_and(m, self.live_mask())
        if m is None:
            return torch.ones(self.capacity, dtype=torch.bool,
                              device=self.device)
        return m

    # -- host-side helpers ----------------------------------------------------

    def compact(self) -> "Table":
        """Slice off dead rows. Reads `num_rows` on the host (one sync)."""
        if self.num_rows is None:
            return self
        n = int(self.num_rows)
        cols = tuple(
            replace(c, data=c.data[:n],
                    valid=None if c.valid is None else c.valid[:n])
            for c in self.columns)
        return Table(columns=cols, names=self.names, num_rows=None)
