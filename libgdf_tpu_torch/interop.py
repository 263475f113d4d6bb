"""Carry tables between numpy and the port's tensors.

`from_numpy` builds a Table from numpy columns and null masks, on the card
unless the caller passes `device="cpu"`; `to_numpy` brings a Table's live
rows back (it reads `num_rows`, so it syncs). The tests feed the same
numpy columns to this package and to `libgdf_tpu`, and compare the
outputs through these two functions.
"""
from __future__ import annotations

import numpy as np

from .core.table import Table
from .utils.tracing import host_sync


def from_numpy(columns: dict, nulls: dict | None = None,
               device=None) -> Table:
    """{name: array}, {name: bool null mask (True = NULL)} -> Table on
    `device`, by default the card. Where there is no CUDA device it raises
    unless `device="cpu"` is passed; it never falls back to the CPU."""
    return Table.from_dict(columns, nulls=nulls, device=device)


def to_numpy(table: Table):
    """Table -> ({name: values}, {name: bool null mask}) over its live
    rows."""
    t = table.compact()
    values, nulls = {}, {}
    with host_sync("interop.to_numpy"):
        for name, c in zip(t.names, t.columns):
            values[name] = c.data.cpu().numpy()
            nulls[name] = (np.zeros(c.size, bool) if c.valid is None
                           else ~c.valid.cpu().numpy())
    return values, nulls
