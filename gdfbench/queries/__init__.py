"""The queries' plans over the public API of libgdf_tpu_torch.

Each module `<query>.py` holds one query's plan as a SQL planner over this
library would emit it: `prepare(db)` wraps the generated tensors as the
library's Tables once (set-up), and `run(state, params, span)` is the entry
the window drives, one query with its substitution parameters. A plan
across processes has `prepare_dist` / `run_dist` over `parallel`. Every
call into a layer of the library sits inside a span named after the layer
(`span("filter")`, ...), which the traced run reads.

The helpers here are the planner's: column types, literal columns, the
projection and the slicing of a sharded table to its live rows.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from libgdf_tpu_torch import Column, Table
from libgdf_tpu_torch.core import DtypeInfo, GDFDtype
from libgdf_tpu_torch.parallel import ShardedTable

TYPES = {"int8": GDFDtype.INT8, "int32": GDFDtype.INT32,
         "float64": GDFDtype.FLOAT64, "date32": GDFDtype.DATE32}


@dataclass
class QueryResult:
    """What one query gave: `answer`, the result rows on the host
    ({column: numpy array}); `counts`, the rows that each step kept
    ({step: int}, or a list of ints a shard across shards); `groups`, the
    whole group-by output ({column: tensor}, this process's shards); and
    `filter_bytes`, the logical bytes of each filter (roofline.py)."""

    answer: dict
    counts: dict
    groups: dict | None = None
    filter_bytes: list = field(default_factory=list)


def to_table(cols: dict, types: dict) -> Table:
    """The library's Table over generated tensors (no copy), each column of
    the configuration's type."""
    return Table.from_columns([
        Column.from_array(cols[name], gdf_dtype=TYPES[t], name=name)
        for name, t in types.items()])


def literal(value: float, rows: int, like: torch.Tensor) -> Column:
    """A float64 literal column of `rows` rows (one element, broadcast)."""
    data = torch.full((), value, dtype=torch.float64,
                      device=like.device).expand(rows)
    return Column(data=data, info=DtypeInfo(GDFDtype.FLOAT64),
                  name=f"lit_{value}")


def host_columns(table: Table) -> dict:
    """The live rows of a Table, column by column, on the host."""
    t = table.compact()
    return {name: c.data.cpu().numpy() for name, c in zip(t.names,
                                                          t.columns)}


def head(table: Table, rows: int) -> Table:
    """The first `rows` rows of every column (views), all live."""
    cols = tuple(Column(data=c.data[:rows],
                        valid=None if c.valid is None else c.valid[:rows],
                        info=c.info, name=c.name) for c in table.columns)
    return Table(columns=cols, names=table.names)


def shrink(st: ShardedTable) -> tuple:
    """A sharded table sliced to its largest shard's live rows (views), and
    every shard's live count: what a planner does after a step whose
    output capacity is its input's, so that the next step works on the
    rows that are left. One host read of the counts."""
    counts = st.counts.tolist()
    cap = max(max(counts), 1)
    shards = tuple(head(s, min(cap, s.capacity)) for s in st.shards)
    return ShardedTable(shards=shards, counts=st.counts,
                        overflow=st.overflow), counts


def project(st: ShardedTable, names) -> ShardedTable:
    """The same shards with only the named columns (no data moves)."""
    return ShardedTable(shards=tuple(s.select(names) for s in st.shards),
                        counts=st.counts, overflow=st.overflow)


def sharded(locals_: list, counts: list, types: dict) -> ShardedTable:
    """A ShardedTable of this process's shards, each a {column: tensor}
    padded to one capacity, with the live counts of every shard of the
    mesh (`counts`, in global shard order) on the first shard's device."""
    shards = tuple(to_table(cols, types) for cols in locals_)
    dev = shards[0].device
    return ShardedTable(shards=shards,
                        counts=torch.tensor(counts, dtype=torch.int32,
                                            device=dev))
