"""Dense columns + validity → CSR.

≅ reference gdf_to_csr (libgdf/io/convert/gdf-to-csr.cu:78-327, struct
csr_gdf convert_types.h:31-39): row-major walk over the table's cells,
emitting every VALID field into A (values), JA (column index) with IA the
per-row exclusive offsets (size rows+1).

Counterpart of `libgdf_tpu/io/csr.py`, with its algorithm: the cell matrix
row-major, the valid cells' indices from `compaction_indices` (H1 on the
card), one gather, and IA from `engine.cumsum` over the per-row counts (H2
on the card).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.dtypes import GDFDtype
from ..core.errors import GDFStatus, require
from ..ops import engine
from ..ops.compaction import compaction_indices


@dataclass
class CSR:
    """≅ csr_gdf (convert_types.h:31-39)."""
    A: torch.Tensor            # values, length >= nnz (padded; live = nnz)
    IA: torch.Tensor           # row offsets, size rows+1
    JA: torch.Tensor           # column index per value (int64, like reference)
    dtype: GDFDtype
    nnz: torch.Tensor
    rows: int
    cols: int


def gdf_to_csr(columns, num_cols: int | None = None) -> CSR:
    """≅ gdf_to_csr (io_functions.h; impl gdf-to-csr.cu:78-327)."""
    cols = list(columns)
    if num_cols is not None:
        cols = cols[:num_cols]
    require(len(cols) > 0, GDFStatus.GDF_DATASET_EMPTY)
    dt = cols[0].data.dtype
    gdt = cols[0].info.gdf_dtype
    for c in cols:
        require(c.data.dtype == dt, GDFStatus.GDF_DTYPE_MISMATCH,
                "CSR requires uniform dtype")
    n, k = cols[0].size, len(cols)

    # cell matrix [rows, cols], row-major like the reference's walk
    data = torch.stack([c.data for c in cols], dim=1)
    valid = torch.stack([c.valid_or_true() for c in cols], dim=1)

    perm, nnz = compaction_indices(valid.reshape(-1))
    A = data.reshape(-1)[perm.to(torch.int64)]
    JA = (perm % k).to(torch.int64)
    per_row = valid.sum(dim=1, dtype=torch.int32)
    IA = torch.cat([torch.zeros(1, dtype=torch.int32, device=data.device),
                    engine.cumsum(per_row, torch.int32)])
    return CSR(A=A, IA=IA, JA=JA, dtype=gdt, nnz=nnz, rows=n, cols=k)
