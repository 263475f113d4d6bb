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

import numpy as np
import torch

from .bitmask import mask_and
from .column import Column, as_tensor, column_concat
from .errors import GDFStatus, require
from ..utils.tracing import host_sync, spanned

_BLOCK = 4096                         # rows a block of the live mask


def live_rows(n: int, num_rows, device) -> torch.Tensor:
    """bool[n]: True for the rows below `num_rows` (a 0-d tensor on
    `device` or an int; None: every row), with no host read. One broadcast
    compare of a block's lanes against each block's rows left writes the
    mask once; an iota of n rows compared with the count would be a slow
    pass of its own (torch's index kernel)."""
    if num_rows is None:
        return torch.ones(n, dtype=torch.bool, device=device)
    lane = torch.arange(_BLOCK, device=device)
    start = torch.arange(0, n, _BLOCK, device=device)
    return (lane < (num_rows - start)[:, None]).reshape(-1)[:n]


def _count_tensor(num_rows, device) -> Optional[torch.Tensor]:
    if num_rows is None:
        return None
    if isinstance(num_rows, torch.Tensor):
        return num_rows.to(device=device, dtype=torch.int32).reshape(())
    with host_sync("table.count"):          # a blocking copy
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
        given; numpy data goes to `device`, by default the card (raises
        where there is none: pass device="cpu")."""
        nulls = nulls or {}
        cols = [Column.from_masked(v, nulls.get(k), name=k, device=device)
                for k, v in data.items()]
        return Table.from_columns(cols)

    @staticmethod
    def from_pandas(df, device=None) -> "Table":
        """A pandas DataFrame's columns, NaN / NA as NULL; devices as in
        from_dict."""
        cols = []
        for name in df.columns:
            s = df[name]
            null = s.isna().to_numpy()
            vals = s.to_numpy()
            if null.any():
                vals = np.where(null, 0, vals).astype(vals.dtype)
                cols.append(Column.from_masked(vals, null, name=str(name),
                                               device=device))
            else:
                cols.append(Column.from_array(vals, name=str(name),
                                              device=device))
        return Table.from_columns(cols)

    # -- introspection -------------------------------------------------------

    @property
    def capacity(self) -> int:
        """Row capacity (tensor length)."""
        return self.columns[0].size

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def device(self) -> torch.device:
        return self.columns[0].device

    def row_count(self):
        """Live row count: the 0-d `num_rows` tensor, or the capacity."""
        return self.capacity if self.num_rows is None else self.num_rows

    def column(self, name: str) -> Column:
        try:
            return self.columns[self.names.index(name)]
        except ValueError:
            raise KeyError(name) from None

    def __getitem__(self, name: str) -> Column:
        return self.column(name)

    def select(self, names: Sequence[str]) -> "Table":
        cols = tuple(self.column(n) for n in names)
        return replace(self, columns=cols, names=tuple(names))

    def replace_column(self, name: str, col: Column) -> "Table":
        i = self.names.index(name)
        cols = list(self.columns)
        cols[i] = col.with_name(name)
        return replace(self, columns=tuple(cols))

    def with_column(self, col: Column) -> "Table":
        if col.name in self.names:
            return self.replace_column(col.name, col)
        return replace(self, columns=self.columns + (col,),
                       names=self.names + (col.name,))

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
        return live_rows(self.capacity, self.num_rows, self.device)

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

    def _indices(self, idx) -> torch.Tensor:
        return as_tensor(idx, self.device, torch.int32).to(torch.int64)

    def rows_equal(self, other: "Table", my_idx, other_idx) -> torch.Tensor:
        """Row equality between index vectors into two tables; out-of-range
        indices are clipped.

        ≅ gdf_table::rows_equal (gdf_table.cuh:580-691): a row holding a
        NULL equals nothing."""
        require(self.num_columns == other.num_columns,
                GDFStatus.GDF_JOIN_DTYPE_MISMATCH, "column count mismatch")
        mi = self._indices(my_idx).clamp(0, max(self.capacity - 1, 0))
        oi = other._indices(other_idx).clamp(0, max(other.capacity - 1, 0))
        eq = self.row_validity()[mi] & other.row_validity()[oi]
        for a, b in zip(self.columns, other.columns):
            require(a.info.gdf_dtype == b.info.gdf_dtype,
                    GDFStatus.GDF_JOIN_DTYPE_MISMATCH,
                    f"dtype mismatch {a.name}/{b.name}")
            eq = eq & (a.data[mi] == b.data[oi])
        return eq

    @spanned("libgdf.op.gather")
    def gather(self, indices, fill_invalid: bool = False,
               num_rows=None) -> "Table":
        """New table = rows at `indices` (clipped into range).

        ≅ gdf_table::gather(range_check) (gdf_table.cuh:874-1010): with
        `fill_invalid`, out-of-range indices (the -1 of outer joins) give
        NULL rows."""
        idx = self._indices(indices)
        in_range = None
        if fill_invalid:
            in_range = (idx >= 0) & (idx < self.capacity)
        idx = idx.clamp(0, max(self.capacity - 1, 0))
        cols = []
        for c in self.columns:
            valid = None if c.valid is None else c.valid[idx]
            cols.append(replace(c, data=c.data[idx],
                                valid=mask_and(valid, in_range)))
        return Table(columns=tuple(cols), names=self.names,
                     num_rows=_count_tensor(num_rows, self.device))

    def scatter(self, locations, out_capacity: int | None = None) -> "Table":
        """New table with row i placed at locations[i]; untouched rows are
        zero and, in a nullable column, NULL.

        ≅ gdf_table::scatter (gdf_table.cuh:1071-1192)."""
        loc = self._indices(locations)
        cap = out_capacity or self.capacity
        cols = []
        for c in self.columns:
            data = torch.zeros(cap, dtype=c.data.dtype, device=self.device)
            data[loc] = c.data
            valid = c.valid
            if valid is not None:
                valid = torch.zeros(cap, dtype=torch.bool, device=self.device)
                valid[loc] = c.valid
            cols.append(replace(c, data=data, valid=valid))
        return Table(columns=tuple(cols), names=self.names,
                     num_rows=self.num_rows)

    # -- host-side helpers ----------------------------------------------------

    def compact(self) -> "Table":
        """Slice off dead rows. Reads `num_rows` on the host (one sync)."""
        if self.num_rows is None:
            return self
        with host_sync("table.compact"):
            n = int(self.num_rows)
        cols = tuple(
            replace(c, data=c.data[:n],
                    valid=None if c.valid is None else c.valid[:n])
            for c in self.columns)
        return Table(columns=cols, names=self.names, num_rows=None)

    def to_pandas(self):
        import pandas as pd
        t = self.compact()
        out = {}
        for name, c in zip(t.names, t.columns):
            vals, nulls = c.to_numpy_masked()
            if nulls.any():
                s = pd.Series(vals)
                s[nulls] = pd.NA
                out[name] = s
            else:
                out[name] = pd.Series(vals)
        return pd.DataFrame(out)


def table_concat(tables: Sequence[Table]) -> Table:
    """Row-wise concatenation (≅ gdf_column_concat per column,
    src/column.cpp:53-153). Every input must be fully live (no num_rows)."""
    first = tables[0]
    for t in tables:
        require(t.names == first.names, GDFStatus.GDF_DTYPE_MISMATCH,
                "schema mismatch in concat")
        require(t.num_rows is None, GDFStatus.GDF_INVALID_API_CALL,
                "concat of padded tables: compact() first")
    cols = tuple(column_concat([t.columns[i] for t in tables])
                 for i in range(first.num_columns))
    return Table(columns=cols, names=first.names)
