"""Carry tables between numpy and the port's tensors.

`from_numpy` builds a Table on a chosen device from numpy columns and null
masks; `to_numpy` brings a Table's live rows back (it reads `num_rows`, so
it syncs). The tests feed the same numpy columns to this package and to
`libgdf_tpu`, and compare the outputs through these two functions.
"""
from __future__ import annotations

import numpy as np

from .core.table import Table


def from_numpy(columns: dict, nulls: dict | None = None,
               device=None) -> Table:
    """{name: array}, {name: bool null mask (True = NULL)} -> Table on
    `device` (default: the CPU)."""
    return Table.from_dict(columns, nulls=nulls, device=device)


def to_numpy(table: Table):
    """Table -> ({name: values}, {name: bool null mask}) over its live
    rows."""
    t = table.compact()
    values, nulls = {}, {}
    for name, c in zip(t.names, t.columns):
        values[name] = c.data.cpu().numpy()
        nulls[name] = (np.zeros(c.size, bool) if c.valid is None
                       else ~c.valid.cpu().numpy())
    return values, nulls
