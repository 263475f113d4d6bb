"""Joins: inner / left / full (outer), single- or multi-column keys.

Counterpart of `libgdf_tpu/ops/join.py` (≅ gdf_inner_join / gdf_left_join
/ gdf_full_join, libgdf/src/join/joining.cu:571-653), with the same output
row order. Two paths, chosen from the input alone:

- the hash path, for an inner join on one key column (of an H6 dtype):
  H6 builds a table of the build side's keys and probes it with every
  probe row (ops/kernels/hash.py); one host read (`join.hash.count`)
  carries the match count and whether a build key came twice. Where none
  did, the matched pairs are sorted by (key, probe row), the sort path's
  order; where one did, the join runs on the sort path instead;
- the sort path, with the JAX package's algorithm: both sides are
  merge-sorted on their keys, exact scans give every sorted position its
  emit count and output offset, and then

  - the fast path (every key run holds at most one build row) fills the
    run's build row forward (H3 carry scan) and compacts the emitting
    positions (H1);
  - the general path compacts the emitting positions (H1) and expands
    them over the output slots (H4).

Each join counts its path in `utils.tracing.counters()` (`join.hash`,
`join.sort`, and `join.hash_fallback` where a duplicate sent the hash
path's join to the sort) and runs inside the span `libgdf.join.hash` /
`libgdf.join.sort`. Null semantics are the reference's: a NULL (or NaN)
key never matches; LEFT emits right index -1 for an unmatched probe row,
FULL also emits (-1, r) for an unmatched build row. The JAX package picks
the sort path's branch with `lax.cond`; here it is a host branch on one
device value.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..core.bitmask import mask_or
from ..core.bits import flush_float_keys
from ..core.column import Column
from ..core.errors import GDFStatus, require
from ..core.table import Table, live_rows
from ..utils.tracing import count, host_sync, span, spanned
from . import engine
from .compaction import compact_arrays
from .engine import last_valid_scan, multi_sort
from .kernels import SENTINEL, expand_fill, hash_build, hash_probe
from .kernels.hash import KEY_DTYPES as HASH_KEY_DTYPES
from .sort import SIGN, radix_bits, radix_encode

_PACK_MAX = 1 << 28  # per-side row ceiling of the packed emit plan


def _join_keys(table: Table, names: Sequence[str]):
    """Return (int64 key encodings, key bit widths, no_match bool[n] or
    None). no_match marks rows that can never match: a NULL key in any key
    column, a NaN float key, or a dead row."""
    keys, widths, no_match = [], [], None
    for name in names:
        col = table.column(name)
        data = col.data
        if data.is_floating_point():
            no_match = mask_or(no_match, torch.isnan(data))
            data = flush_float_keys(data)
        keys.append(radix_encode(data, ascending=True))
        widths.append(data.element_size() * 8)
        if col.valid is not None:
            no_match = mask_or(no_match, ~col.valid)
    if table.num_rows is not None:
        no_match = mask_or(no_match, ~table.live_mask())
    return keys, widths, no_match


def lex_searchsorted(sorted_keys, query_keys, side: str) -> torch.Tensor:
    """For each query row, its insertion point (int32) into the
    lexicographically sorted multi-key tensors ("left": before equal rows,
    "right": after them). Every query advances in lockstep: ceil(log2(n+1))
    rounds of one gather and compare per key column, as in
    libgdf_tpu/ops/join.py::lex_searchsorted. Keys are compared as signed
    tensors (the port's signed-form encodings). Window RANGE frames use it;
    the join itself does not."""
    n = sorted_keys[0].shape[0]
    m = query_keys[0].shape[0]
    dev = query_keys[0].device
    lo = torch.zeros(m, dtype=torch.int64, device=dev)
    hi = torch.full((m,), n, dtype=torch.int64, device=dev)
    for _ in range(max(1, (n + 1).bit_length())):
        mid = (lo + hi) >> 1
        at = mid.clamp(0, max(n - 1, 0))
        lt = torch.zeros(m, dtype=torch.bool, device=dev)
        eq = torch.ones(m, dtype=torch.bool, device=dev)
        for s, q in zip(sorted_keys, query_keys):
            sv = s[at] if n else torch.zeros_like(q)
            lt = lt | (eq & (sv < q))
            eq = eq & (sv == q)
        go_right = ((lt | eq) if side == "right" else lt) & (lo < hi)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right | (lo >= hi), hi, mid)
    return lo.to(torch.int32)


@spanned("libgdf.op.join_indices")
def join_indices(left: Table, right: Table, left_on: Sequence[str],
                 right_on: Sequence[str], how: str = "inner",
                 out_capacity: int | None = None,
                 assume_unique_build: bool = False):
    """Join index columns: (left_idx int32[cap], right_idx int32[cap],
    count int64 0-d), -1 marking the unmatched side of an outer row.

    The build side is `right`. `out_capacity=None` sizes the output
    exactly (reads the count on the host); an output larger than the
    capacity raises. `assume_unique_build=True` runs only the fast path
    and poisons the count to -1 if the build side has duplicate keys."""
    require(how in ("inner", "left", "full"),
            GDFStatus.GDF_UNSUPPORTED_JOIN_TYPE, how)
    return _join_indices_impl(left, right, left_on, right_on, how,
                              out_capacity, assume_unique_build)


def _join_indices_impl(left, right, left_on, right_on, how, out_capacity,
                       assume_unique_build):
    require(len(left_on) == len(right_on) and len(left_on) > 0,
            GDFStatus.GDF_JOIN_DTYPE_MISMATCH, "key column count mismatch")
    for a, b in zip(left_on, right_on):
        require(left.column(a).info.gdf_dtype ==
                right.column(b).info.gdf_dtype,
                GDFStatus.GDF_JOIN_DTYPE_MISMATCH,
                f"join key dtype mismatch {a}/{b}")
    if (how == "inner" and len(left_on) == 1
            and left.column(left_on[0]).data.dtype in HASH_KEY_DTYPES):
        with span("libgdf.join.hash"):
            out = _hash_join(left, right, left_on[0], right_on[0],
                             out_capacity)
        if out is not None:
            count("join.hash")
            return out
        count("join.hash_fallback")
    count("join.sort")
    with span("libgdf.join.sort"):
        return _sort_join(left, right, left_on, right_on, how, out_capacity,
                          assume_unique_build)


def _hash_join(left, right, lname, rname, out_capacity):
    """The inner join on one key through H6: (left_idx, right_idx, count)
    as `join_indices` gives them, or None where the build side holds a key
    twice. The probe writes at most min(probe capacity, out_capacity)
    pairs and counts them all."""
    pcol, bcol = left.column(lname), right.column(rname)
    m = left.capacity
    buf = m if out_capacity is None else min(m, int(out_capacity))
    table = hash_build(bcol.data.contiguous(), _contiguous(bcol.valid),
                       right.num_rows)
    p_rows, b_rows, result = hash_probe(
        table, pcol.data.contiguous(), _contiguous(pcol.valid),
        left.num_rows, buf)
    with host_sync("join.hash.count"):     # the hash path's one host read
        total_host, dup = result.tolist()
    if dup:
        return None
    cap = total_host if out_capacity is None else int(out_capacity)
    require(total_host <= cap, GDFStatus.GDF_COLUMN_SIZE_TOO_BIG,
            f"join output {total_host} rows > out_capacity {cap}")
    left_idx, right_idx = _match_order(pcol.data, p_rows[:total_host],
                                       b_rows[:total_host])
    return _fit_cap(left_idx, cap), _fit_cap(right_idx, cap), result[0]


def _contiguous(x):
    return None if x is None else x.contiguous()


def _match_order(keys, p, b):
    """The matched (probe row, build row) pairs in the sort path's order:
    by the key's encoding, then by probe row."""
    if p.shape[0] == 0:
        return p, b
    k = keys[p.to(torch.int64)]
    if k.is_floating_point():
        k = flush_float_keys(k)
    _, s_p, s_b = _key_row_sort(radix_encode(k, ascending=True),
                                k.element_size() * 8, p.to(torch.int64), b)
    return s_p.to(torch.int32), s_b


def _key_row_sort(enc, width, low, *payload):
    """Sort rows by (key, low), both join paths' order: (sorted key, sorted
    low, *payload sorted with them). `enc` is the key's int64 radix
    encoding of `width` bits, `low` an int64 below 2^32. A key of at most
    32 bits sorts with its low word as one word, (U << 32) | low; the
    sorted key is then U, a value of the same order."""
    if width <= 32:
        word = ((radix_bits(enc, width) << 32) | low) ^ SIGN
        s_word, *rest = multi_sort([word, *payload], num_keys=1)
        s_word = s_word ^ SIGN
        return (s_word >> 32, s_word & 0xFFFFFFFF, *rest)
    return tuple(multi_sort([enc, low, *payload], num_keys=2))


def _sort_join(left, right, left_on, right_on, how, out_capacity,
               assume_unique_build):
    """The sort path: both sides merge-sorted on their keys together."""
    dev = left.device
    n, m = right.capacity, left.capacity
    L = n + m

    bkeys, widths, b_nomatch = _join_keys(right, right_on)
    pkeys, _, p_nomatch = _join_keys(left, left_on)
    b_live = right.live_mask()
    p_live = left.live_mask()

    total, emit, offsets, s_back, run_lower, flag_bits, aux = _emit_plan(
        how, bkeys, widths, pkeys, b_nomatch, p_nomatch, b_live, p_live)

    with host_sync("join.total"):
        total_host = int(total)
    cap = total_host if out_capacity is None else int(out_capacity)
    require(total_host <= cap, GDFStatus.GDF_COLUMN_SIZE_TOO_BIG,
            f"join output {total_host} rows > out_capacity {cap}")
    if cap == 0 or L == 0:
        neg = torch.full((cap,), -1, dtype=torch.int32, device=dev)
        return neg, neg.clone(), total

    isq, live, matchable, cnt = (aux["isq"], aux["live"], aux["matchable"],
                                 aux["cnt"])
    is_build = ~isq

    # A run's build multiplicity: 1-based build rank within its run. When
    # every matchable run holds <= 1 build row, no probe row matches twice.
    b_rank = torch.where(is_build & matchable,
                         aux["nbuild_before"] - run_lower + 1, 0)
    with host_sync("join.unique_build"):
        unique_build = bool(b_rank.max() <= 1)

    if assume_unique_build:
        left_idx, right_idx = _fast_path(how, aux, is_build, isq, live, cnt,
                                         s_back, cap)
        if not unique_build:
            total = torch.full_like(total, -1)
    elif unique_build:
        left_idx, right_idx = _fast_path(how, aux, is_build, isq, live, cnt,
                                         s_back, cap)
    else:
        left_idx, right_idx = _general_path(
            how, n, m, cap, emit, offsets, s_back, run_lower, flag_bits,
            bkeys, b_nomatch)
    slot_live = live_rows(cap, total, dev)
    left_idx = torch.where(slot_live, left_idx, -1)
    right_idx = torch.where(slot_live, right_idx, -1)
    return left_idx, right_idx, total


def _fast_path(how, aux, is_build, isq, live, cnt, s_back, cap):
    """Fill each run's single build row forward (build rows sort before
    probes within a run) and compact the emitting positions."""
    b_fill, _ = last_valid_scan(is_build, s_back)
    hit = isq & (cnt > 0)
    keep = hit
    l_src = torch.where(isq, s_back, -1)
    r_src = torch.where(hit, b_fill, -1)
    if how in ("left", "full"):
        keep = keep | (isq & live & (cnt == 0))
    if how == "full":
        keep = keep | (is_build & live & ~aux["b_matched"])
        r_src = torch.where(is_build, s_back, r_src)
    (l_c, r_c), _ = compact_arrays([l_src, r_src], keep)
    return _fit_cap(l_c, cap), _fit_cap(r_c, cap)


def _general_path(how, n, m, cap, emit, offsets, s_back, run_lower,
                  flag_bits, bkeys, b_nomatch):
    """Many-to-many expansion: compact the emitting positions to a dense
    (output offset, words) list, expand it over the output slots, then
    rank = slot - base picks each slot's build row. The word
    w1 = (s_back + 1) << 2 | flags carries the source row and its flags."""
    require(cap < SENTINEL, GDFStatus.GDF_COLUMN_SIZE_TOO_BIG,
            f"join output capacity {cap} >= 2^30")
    dev = emit.device
    L = n + m
    wdt = torch.int32 if max(n, m, 1) < _PACK_MAX else torch.int64
    w1s = ((s_back.to(wdt) + 1) << 2) | flag_bits.to(wdt)
    # Offsets at or past the capacity become SENTINEL before compaction:
    # those slots are dropped either way, and the expansion needs sorted
    # positions.
    pos_src = torch.where((offsets >= 0) & (offsets < cap), offsets,
                          SENTINEL)
    (pos_c, w1_c, lo_c), n_src = compact_arrays(
        [pos_src, w1s, run_lower + 1], emit > 0)
    pos_c = torch.where(torch.arange(L, dtype=torch.int32, device=dev)
                        < n_src, pos_c, SENTINEL)
    w1, lo_f, base = expand_fill(pos_c, [w1_c, lo_c, pos_c], cap)
    j = torch.arange(cap, dtype=torch.int32, device=dev)
    rank = j - base
    lo_j = lo_f - 1
    from_query = (w1 & 2) != 0
    matched = (w1 & 1) != 0
    s_back_j = ((w1 >> 2) - 1).to(torch.int32)

    # Sorted-build position -> original build row, from a stable sort of
    # the build side alone (consistent with the build ranks of the merge).
    if n > 0:
        bflag = (torch.zeros(n, dtype=torch.uint8, device=dev)
                 if b_nomatch is None else b_nomatch.to(torch.uint8))
        bsort = multi_sort([bflag] + bkeys +
                           [torch.arange(n, dtype=torch.int32, device=dev)],
                           num_keys=1 + len(bkeys))
        build_perm = bsort[-1]
    else:
        build_perm = torch.zeros(1, dtype=torch.int32, device=dev)
    r_sorted_pos = (lo_j + rank).clamp(0, max(n - 1, 0)).to(torch.int64)
    r_from_match = build_perm[r_sorted_pos]

    left_idx = torch.where(from_query, s_back_j, -1)
    right_idx = torch.where(from_query & matched, r_from_match, -1)
    if how == "full":
        right_idx = torch.where(~from_query, s_back_j, right_idx)
    return left_idx, right_idx


def _fit_cap(x: torch.Tensor, cap: int) -> torch.Tensor:
    n = x.shape[0]
    if cap <= n:
        return x[:cap]
    return torch.cat([x, torch.full((cap - n,), -1, dtype=x.dtype,
                                    device=x.device)])


def _emit_plan(how, bkeys, widths, pkeys, b_nomatch, p_nomatch, b_live,
               p_live):
    """Merge-sort both sides on their keys and compute, per sorted
    position: the emit count, exclusive output offsets, the original row
    id (`s_back`) and the run's lower bound (matchable-build rank of the
    run start). See libgdf_tpu/ops/join.py::_emit_plan.

    Single-key joins pack everything below the key into one low word:
    [31] is_query | [30] matchable | [29] live | [28:0] row index, so
    no-match build rows sort before matchable ones inside a run. A key of
    at most 32 bits shares that word ((U << 32) | low); a 64-bit key sorts
    as (key, low). Multi-key joins sort a leading no-match flag, the keys,
    is_query and the row index."""
    n, m = b_live.shape[0], p_live.shape[0]
    L = n + m
    dev = b_live.device
    if L == 0:
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return torch.zeros((), dtype=torch.int64, device=dev), z, z, z, z, z, {}

    def ones(x, k):
        return torch.ones(k, dtype=torch.bool, device=dev) if x is None else x

    if len(bkeys) == 1 and max(n, m) < _PACK_MAX:
        enc = torch.cat([bkeys[0], pkeys[0]])
        isq_b = torch.cat([torch.zeros(n, dtype=torch.int64, device=dev),
                           torch.ones(m, dtype=torch.int64, device=dev)])
        matchable_b = torch.cat([
            ones(None if b_nomatch is None else ~b_nomatch, n),
            ones(None if p_nomatch is None else ~p_nomatch, m)]).to(
                torch.int64)
        live_b = torch.cat([b_live, p_live]).to(torch.int64)
        back_b = torch.cat([torch.arange(n, dtype=torch.int64, device=dev),
                            torch.arange(m, dtype=torch.int64, device=dev)])
        low = (isq_b << 31) | (matchable_b << 30) | (live_b << 29) | back_b
        s_key, s_low = _key_row_sort(enc, widths[0], low)
        s_keys = [s_key]
        s_isq = ((s_low >> 31) & 1).to(torch.int32)
        s_matchable = ((s_low >> 30) & 1) != 0
        s_live = ((s_low >> 29) & 1) != 0
        s_back = (s_low & (_PACK_MAX * 2 - 1)).to(torch.int32)
        countable = ((s_isq == 0) & s_matchable).to(torch.int32)
    else:
        bflag = (torch.zeros(n, dtype=torch.uint8, device=dev)
                 if b_nomatch is None else b_nomatch.to(torch.uint8))
        flag = torch.cat([bflag, torch.zeros(m, dtype=torch.uint8,
                                             device=dev)])
        is_query = torch.cat([torch.zeros(n, dtype=torch.uint8, device=dev),
                              torch.ones(m, dtype=torch.uint8, device=dev)])
        back = torch.cat([torch.arange(n, dtype=torch.int32, device=dev),
                          torch.arange(m, dtype=torch.int32, device=dev)])

        def ctl(nomatch, live):
            matchable = ones(None if nomatch is None else ~nomatch,
                             live.shape[0])
            return matchable.to(torch.uint8) | (live.to(torch.uint8) << 1)

        ctls = torch.cat([ctl(b_nomatch, b_live), ctl(p_nomatch, p_live)])
        keys = [torch.cat([b, q]) for b, q in zip(bkeys, pkeys)]
        res = multi_sort([flag] + keys + [is_query, back, ctls],
                         num_keys=1 + len(keys) + 1)
        s_keys = res[:1 + len(keys)]   # the flag word takes part in runs
        s_isq = res[-3].to(torch.int32)
        s_back = res[-2]
        s_matchable = (res[-1] & 1) != 0
        s_live = (res[-1] & 2) != 0
        countable = 1 - s_isq

    nbuild_before = engine.cumsum(countable, torch.int32) - countable
    key_change = torch.zeros(L, dtype=torch.bool, device=dev)
    with host_sync("join.key_change"):      # a blocking copy
        key_change[0] = True
    for k in s_keys:
        key_change[1:] |= k[1:] != k[:-1]
    run_lower = engine.cummax(torch.where(key_change, nbuild_before, -1))

    isq = s_isq == 1
    cnt = torch.where(isq & s_matchable, nbuild_before - run_lower, 0)
    has_match = cnt > 0
    emit = cnt
    aux = dict(isq=isq, live=s_live, matchable=s_matchable, cnt=cnt,
               nbuild_before=nbuild_before)
    if how in ("left", "full"):
        emit = torch.where(isq & s_live & (cnt == 0), 1, emit)
    if how == "full":
        run_id = engine.cumsum(key_change, torch.int32) - 1
        qrun = torch.where(isq & s_matchable, run_id, 2 ** 31 - 1)
        b_matched = ((engine.cummin(qrun, reverse=True) == run_id)
                     & ~isq & s_matchable)
        emit = torch.where(~isq & s_live & ~b_matched, 1, emit)
        aux["b_matched"] = b_matched

    offsets = engine.cumsum(emit, torch.int32) - emit
    # Exact count in int64: never wraps, so an overflow is detectable.
    total = emit.sum(dtype=torch.int64)
    flag_bits = (s_isq << 1) | has_match.to(torch.int32)
    return total, emit, offsets, s_back, run_lower, flag_bits, aux


@spanned("libgdf.op.join")
def join(left: Table, right: Table, left_on: Sequence[str],
         right_on: Sequence[str], how: str = "inner",
         out_capacity: int | None = None, suffixes=("_x", "_y")) -> Table:
    """Materialized join result (≅ construct_join_output_df, joining.cu:
    375-479): key columns from the left side (from the right side for
    FULL-join rows with no left match); other columns of both tables are
    gathered by the index columns, -1 giving NULL."""
    l_idx, r_idx, count = join_indices(left, right, left_on, right_on, how,
                                       out_capacity)
    return join_output(left, right, left_on, right_on, how, l_idx, r_idx,
                       count, suffixes)


def join_output(left: Table, right: Table, left_on, right_on, how: str,
                l_idx: torch.Tensor, r_idx: torch.Tensor, count,
                suffixes=("_x", "_y")) -> Table:
    """The materialized table of `join` from its index columns (the
    output's capacity is theirs, its num_rows `count`)."""
    cols = []
    for lname, rname in zip(left_on, right_on):
        lcol = left.column(lname)
        lc = _gather_col(lcol, l_idx)
        if how == "full":
            rc = _gather_col(right.column(rname), r_idx)
            has_l = l_idx >= 0
            lc = Column(data=torch.where(has_l, lc.data, rc.data),
                        valid=torch.where(has_l, lc.valid, rc.valid),
                        info=lcol.info, name=lname)
        cols.append(lc.with_name(lname))
    for name in left.names:
        if name in left_on:
            continue
        cols.append(_gather_col(left.column(name), l_idx).with_name(
            name if name not in right.names else name + suffixes[0]))
    for name in right.names:
        if name in right_on:
            continue
        cols.append(_gather_col(right.column(name), r_idx).with_name(
            name if name not in left.names else name + suffixes[1]))
    return Table.from_columns(cols, num_rows=count)


def _gather_col(col: Column, idx: torch.Tensor) -> Column:
    """Rows at `idx` (clamped, as jnp.take(mode="clip")); -1 -> NULL."""
    ok = idx >= 0
    if col.size == 0:
        return Column(data=torch.zeros(idx.shape, dtype=col.data.dtype,
                                       device=idx.device),
                      valid=torch.zeros(idx.shape, dtype=torch.bool,
                                        device=idx.device),
                      info=col.info, name=col.name)
    safe = idx.clamp(0, col.size - 1).to(torch.int64)
    valid = ok if col.valid is None else ok & col.valid[safe]
    return Column(data=col.data[safe], valid=valid, info=col.info,
                  name=col.name)


def inner_join(left, right, left_on, right_on, **kw):
    """≅ gdf_inner_join (joining.cu:599-625)."""
    return join_indices(left, right, left_on, right_on, "inner", **kw)


def left_join(left, right, left_on, right_on, **kw):
    """≅ gdf_left_join (joining.cu:571-597)."""
    return join_indices(left, right, left_on, right_on, "left", **kw)


def full_join(left, right, left_on, right_on, **kw):
    """≅ gdf_full_join (joining.cu:627-653)."""
    return join_indices(left, right, left_on, right_on, "full", **kw)
