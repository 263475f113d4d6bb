"""Stream compaction: filter rows by a stencil, keeping survivors dense.

Counterpart of `libgdf_tpu/ops/compaction.py` (≅ libgdf/src/
streamcompactionops.cu:163-260, gpu_apply_stencil). Every column's data
and validity go through one launch of the H1 compaction kernel
(ops/kernels/compact.py). The output keeps the input's capacity, and
`num_rows` carries the survivor count (core/table.py).
"""
from __future__ import annotations

import torch

from ..core.column import Column
from ..core.errors import GDFStatus, require
from ..core.table import Table
from ..utils.tracing import spanned
from .kernels import compact


def compaction_indices(keep: torch.Tensor):
    """Return (src_indices: int32[n], count: 0-d int32): the indices of the
    kept rows first, then those of the dropped rows, both in their original
    order. The j-th output row (j < count) comes from src_indices[j].

    The JAX package takes this permutation from a stable sort of the drop
    flag; here it is two H1 compactions of an iota (by `keep`, then by its
    complement), O(n), stitched at the count without a sync."""
    n = keep.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=keep.device)
    (kept,), count = compact_arrays([iota], keep)
    (dropped,), _ = compact_arrays([iota], ~keep)
    tail = (iota - count).clamp(min=0).to(torch.int64)
    return torch.where(iota < count, kept, dropped[tail]), count


def compact_arrays(arrays, keep: torch.Tensor):
    """Stable stream compaction of raw 1-D tensors: (compacted, count)."""
    return compact(arrays, keep)


def compact_table(table: Table, keep: torch.Tensor):
    """Move rows where `keep` to the front (stable). Returns (Table with
    the original capacity, count)."""
    arrays, layout = [], []
    for c in table.columns:
        arrays.append(c.data)
        if c.valid is not None:
            arrays.append(c.valid)
        layout.append(2 if c.valid is not None else 1)
    res, count = compact_arrays(arrays, keep)
    cols, i = [], 0
    for c, w in zip(table.columns, layout):
        valid = res[i + 1] if w == 2 else None
        cols.append(Column(data=res[i], valid=valid, info=c.info,
                           name=c.name))
        i += w
    return Table(columns=tuple(cols), names=table.names), count


def stencil_keep_mask(stencil: Column) -> torch.Tensor:
    """Rows pass iff stencil value != 0 AND the stencil bit is valid
    (streamcompactionops.cu:163-260)."""
    keep = stencil.data != 0
    if stencil.valid is not None:
        keep = keep & stencil.valid
    return keep


def apply_stencil(col: Column, stencil: Column):
    """Compact one column by a stencil. Returns (Column, count), the column
    padded to its original capacity (≅ gdf_apply_stencil)."""
    require(col.size == stencil.size, GDFStatus.GDF_COLUMN_SIZE_MISMATCH)
    keep = stencil_keep_mask(stencil)
    if col.valid is not None:
        (data, valid), count = compact_arrays([col.data, col.valid], keep)
        return col.with_data(data).with_valid(valid), count
    (data,), count = compact_arrays([col.data], keep)
    return col.with_data(data), count


@spanned("libgdf.op.filter_table")
def filter_table(table: Table, stencil: Column) -> Table:
    """Compact every column of a table by one stencil. Returns a Table with
    num_rows = survivor count."""
    require(table.capacity == stencil.size,
            GDFStatus.GDF_COLUMN_SIZE_MISMATCH)
    keep = stencil_keep_mask(stencil)
    if table.num_rows is not None:
        keep = keep & table.live_mask()
    out, count = compact_table(table, keep)
    return out.with_num_rows(count)
