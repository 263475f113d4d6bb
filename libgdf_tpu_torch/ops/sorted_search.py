"""Sorted search (match ranges) via one merge sort.

Counterpart of `libgdf_tpu/ops/sorted_search.py` (≅ mgpu::sorted_search,
src/join/sort/sort-join.cuh:48-66). Build and query keys are sorted
together with a tiebreak that puts build rows before equal query rows; at
each sorted position the exclusive count of build rows before it is the
query's upper bound, and a running max from the start of each equal-key
run carries the lower bound. Scans run on H2; the scatters back to query
order are `scatter_reduce(..., "amax")`.
"""
from __future__ import annotations

import torch

from . import engine
from .engine import multi_sort


def merge_match_ranges(build_keys, query_keys):
    """(build_perm int32[n], lower int32[m], upper int32[m]).

    `build_keys` / `query_keys`: lists of key tensors (most significant
    first) in one order-preserving encoding, e.g. radix_encode's. Build
    rows at sorted-build positions [lower, upper) equal the query row;
    build_perm[s] is the original build row at sorted-build position s."""
    n = build_keys[0].shape[0]
    m = query_keys[0].shape[0]
    dev = build_keys[0].device
    is_query = torch.cat([torch.zeros(n, dtype=torch.int32, device=dev),
                          torch.ones(m, dtype=torch.int32, device=dev)])
    back = torch.cat([torch.arange(n, dtype=torch.int64, device=dev),
                      torch.arange(m, dtype=torch.int64, device=dev)])
    keys = [torch.cat([b, q]) for b, q in zip(build_keys, query_keys)]
    res = multi_sort(keys + [is_query, back], num_keys=len(keys) + 1)
    s_keys, s_isq, s_back = res[:len(keys)], res[-2], res[-1]

    is_build = 1 - s_isq
    nbuild_before = engine.cumsum(is_build) - is_build      # exclusive
    isq = s_isq == 1

    def to_query_order(vals, size, idx, where):
        out = torch.zeros(size, dtype=torch.int32, device=dev)
        if size == 0:
            return out
        return out.scatter_reduce(0, torch.where(where, idx, 0),
                                  torch.where(where, vals, 0), "amax")

    upper = to_query_order(nbuild_before, m, s_back, isq)
    key_change = torch.zeros(n + m, dtype=torch.bool, device=dev)
    key_change[:1] = True
    for k in s_keys:
        key_change[1:] |= k[1:] != k[:-1]
    run_lower = engine.cummax(torch.where(key_change, nbuild_before, -1))
    lower = to_query_order(run_lower, m, s_back, isq)
    build_perm = to_query_order(s_back.to(torch.int32), max(n, 1),
                                nbuild_before.to(torch.int64), ~isq)[:n]
    return build_perm, lower, upper


def sorted_search_bounds(sorted_keys, query_keys):
    """(lower, upper) int32[m] insertion bounds of each query row into the
    already sorted multi-key tensors (np.searchsorted left / right)."""
    _, lower, upper = merge_match_ranges(sorted_keys, query_keys)
    return lower, upper
