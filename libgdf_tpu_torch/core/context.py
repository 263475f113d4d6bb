"""Per-call execution options.

≅ reference `gdf_context` (libgdf/include/gdf/cffi/types.h:161-167) and
`gdf_context_view` (src/context.cpp:3-12): the query-level planner knobs —
sorted-input hint, hash-vs-sort method selection, DISTINCT flag, sort-result
flag.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass


class Method(enum.IntEnum):
    """≅ gdf_method (types.h:101-105)."""

    SORT = 0
    HASH = 1


@dataclass(frozen=True)
class Context:
    flag_sorted: bool = False        # input already sorted
    flag_method: Method = Method.SORT
    flag_distinct: bool = False      # COUNT DISTINCT
    flag_sort_result: bool = False   # sort hash-groupby output
    flag_sort_inplace: bool = False  # kept for ABI parity (meaningless here)


def context_view(flag_sorted=0, flag_method=Method.SORT, flag_distinct=0,
                 flag_sort_result=0, flag_sort_inplace=0) -> Context:
    """≅ gdf_context_view (src/context.cpp:3-12)."""
    return Context(bool(flag_sorted), Method(flag_method),
                   bool(flag_distinct), bool(flag_sort_result),
                   bool(flag_sort_inplace))
