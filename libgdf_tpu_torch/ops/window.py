"""Window functions: partitioned, ordered rolling reductions.

Counterpart of `libgdf_tpu/ops/window.py` (≅ the reference's unfinished
gpu_window_function, src/windowedops.cu:46-148, and the enums
window_function_type / window_reduction_type, types.h:197-210), with the
same algorithm and therefore the same results:

  1. the partition columns become a 32-bit murmur3 row hash (ops/hashing),
     so two partition values whose hashes collide share a partition, as in
     the JAX package;
  2. one sort of packed key words: partition hash | order encodings | row
     index in the low bits, which makes every key unique (the order is the
     JAX package's, ties in the order key included) and carries the
     permutation;
  3. the reduction over the sorted frame: prefix-sum differences for the
     sum family (three float64 prefix sums: H2 at float64 on the card, the
     TPU's K5a), a doubling ladder of partition-clipped shifted extrema for
     ROW min/max, a sparse table for RANGE min/max, and segmented scans
     (H3) for running frames and the partition starts;
  4. back to input order with one scatter, `out[perm] = out_sorted`, where
     the JAX package sorts a second time; the result is identical.

Reductions: sum, min, max, count, avg, stddev, var (population).
Frames: "rows" (`preceding` rows up to the current one; None = running)
and "range" (rows of the partition whose order value lies in
[current - preceding, current], up to the current sorted row).

A denormal float value is zero, as XLA reads it, in every reduction and
frame: min / max flush the values in their own dtype; the sum family
flushes a float32 column before widening it to float64 (where it would be
a normal number, `core/bits.py::to_float64`), and H2 flushes float64
values as it loads them.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from ..core.bits import flush_denormals, to_float64
from ..core.column import Column
from ..core.dtypes import DtypeInfo, GDFDtype
from ..core.errors import GDFStatus, require
from ..core.table import Table
from ..utils.tracing import host_sync
from . import engine
from .engine import multi_sort
from .hashing import hash_columns
from .join import lex_searchsorted
from .sort import (SIGN, bit_field_offsets, pack_bit_fields, radix_bits,
                   radix_decode, radix_encode, radix_from_bits, radix_width,
                   unpack_bit_field)

WINDOW_REDUCTIONS = ("sum", "min", "max", "count", "avg", "stddev", "var")
_SUM_FAMILY = ("sum", "count", "avg", "var", "stddev")


def _segmented_running(vals, seg_start, op):
    """Running `op` over vals, restarting at segment starts (H3)."""
    if op == "sum":
        return engine.seg_scan_sum(vals, seg_start)
    if op == "min":
        return engine.seg_scan_min(vals, seg_start)
    return engine.seg_scan_max(vals, seg_start)


def _part_first(seg_start):
    """(row index, first row index of each row's partition), both int32:
    a segmented running max of the start indices."""
    idx = torch.arange(seg_start.shape[0], dtype=torch.int32,
                       device=seg_start.device)
    return idx, _segmented_running(torch.where(seg_start, idx, 0),
                                   seg_start, "max")


def _minmax_ident(vals, valid, op):
    """(identity, invalid rows replaced by it), in the input dtype: min and
    max are exact there; only the output is cast to float64. A denormal
    value is zero (`core/bits.py::flush_denormals`), as XLA's min / max
    read it."""
    vals = flush_denormals(vals)
    if vals.is_floating_point():
        ident = math.inf if op == "min" else -math.inf
    else:
        info = torch.iinfo(vals.dtype)
        ident = info.max if op == "min" else info.min
    return ident, torch.where(valid, vals, ident)


def _shift_down(x, s: int, fill):
    """y[i] = x[i - s], the first s rows `fill` (0 <= s < len(x))."""
    if s == 0:
        return x
    return torch.cat([torch.full((s,), fill, dtype=x.dtype, device=x.device),
                      x[:-s]])


def _floor_log2(x):
    """Elementwise floor(log2(x)) for integer x >= 1, branch-free."""
    r = torch.zeros_like(x)
    for k in (16, 8, 4, 2, 1):
        big = x >= (1 << k)
        r = torch.where(big, r + k, r)
        x = torch.where(big, x >> k, x)
    return r


def _sum_family_over(v, w, frame_lo, op: str):
    """sum / count / avg / var / stddev over the frames [frame_lo[i], i]:
    three float64 prefix sums and one gather at frame_lo - 1."""
    n = v.shape[0]
    csum = engine.cumsum(v)
    csq = engine.cumsum(v * v)
    ccnt = engine.cumsum(w)
    before = frame_lo > 0
    at = (frame_lo.to(torch.int64) - 1).clamp(0, n - 1)

    def rangesum(c):
        return c - torch.where(before, c[at], 0.0)

    s, sq, cnt = rangesum(csum), rangesum(csq), rangesum(ccnt)
    if op == "sum":
        return s, cnt > 0
    if op == "count":
        return cnt, torch.ones_like(cnt, dtype=torch.bool)
    safe = cnt.clamp(min=1.0)
    mean = s / safe
    if op == "avg":
        return mean, cnt > 0
    varv = (sq / safe - mean * mean).clamp(min=0.0)
    if op == "var":
        return varv, cnt > 0
    return torch.sqrt(varv), cnt > 0


def _windowed(vals, valid, seg_start, preceding: int, op: str):
    """ROW frames [i - preceding + 1, i] clipped to the partition: prefix
    sums for the sum family; for min/max a doubling ladder of K =
    floor(log2(preceding)) shifted extrema, then the frame is the op of two
    overlapping 2^K blocks (no gathers), or one segmented scan when the
    frame is unbounded."""
    n = vals.shape[0]
    idx, part_first = _part_first(seg_start)
    frame_lo = torch.maximum(part_first, idx - min(preceding - 1, n))
    if op in _SUM_FAMILY:
        return _sum_family_over(
            torch.where(valid, to_float64(vals), 0.0),
            valid.to(torch.float64), frame_lo, op)

    ident, cur = _minmax_ident(vals, valid, op)
    hv = valid.to(torch.int32)                  # any-valid ladder (OR)
    if preceding >= n:
        run = _segmented_running(cur, seg_start, op)
        if op == "min" and cur.dtype == torch.float64:
            # the engine orders float64 NaN greatest (the sorts' order), so
            # a NaN never wins its min; a running min propagates it from
            # the partition's first valid NaN on (max agrees already)
            nan_seen = _segmented_running(torch.isnan(cur).to(torch.int32),
                                          seg_start, "max") > 0
            run = torch.where(nan_seen, math.nan, run)
        has = _segmented_running(hv, seg_start, "sum") > 0
        return run.to(torch.float64), has
    vop = torch.minimum if op == "min" else torch.maximum
    K = max(preceding.bit_length() - 1, 0)      # 2^K <= preceding
    g, gh = cur, hv
    for k in range(K):
        s = 1 << k
        in_part = idx - s >= part_first
        g = vop(g, torch.where(in_part, _shift_down(g, s, ident), ident))
        gh = torch.maximum(gh, torch.where(in_part, _shift_down(gh, s, 0),
                                           0))
    # block 2 ends at i - preceding + 2^K and covers the frame's start
    shift2 = preceding - (1 << K)
    j_ok = idx - shift2 >= frame_lo
    red = vop(g, torch.where(j_ok, _shift_down(g, shift2, ident), ident))
    has = torch.maximum(gh, torch.where(j_ok, _shift_down(gh, shift2, 0),
                                        0)) > 0
    return red.to(torch.float64), has


def _windowed_range(vals, valid, seg_start, frame_lo, op: str):
    """Frames [frame_lo[i], i] of varying length (RANGE): prefix sums for
    the sum family; for min/max a partition-clipped sparse table of levels
    0..floor(log2(n)) (a frame may span a whole partition) and the two-block
    lookup at level floor(log2(length))."""
    n = vals.shape[0]
    if op in _SUM_FAMILY:
        return _sum_family_over(
            torch.where(valid, to_float64(vals), 0.0),
            valid.to(torch.float64), frame_lo, op)
    idx, part_first = _part_first(seg_start)
    vop = torch.minimum if op == "min" else torch.maximum
    ident, cur = _minmax_ident(vals, valid, op)
    hv = valid.to(torch.int32)
    nlev = max(n.bit_length(), 1)
    gs = torch.empty((nlev, n), dtype=cur.dtype, device=cur.device)
    ghs = torch.empty((nlev, n), dtype=torch.int32, device=cur.device)
    gs[0], ghs[0] = cur, hv
    for k in range(nlev - 1):
        s = 1 << k
        in_part = idx - s >= part_first
        gs[k + 1] = vop(gs[k], torch.where(
            in_part, _shift_down(gs[k], s, ident), ident))
        ghs[k + 1] = torch.maximum(ghs[k], torch.where(
            in_part, _shift_down(ghs[k], s, 0), 0))
    lo = frame_lo.to(torch.int64)
    K = _floor_log2((idx.to(torch.int64) - lo + 1).clamp(min=1))
    flat_i = K * n + idx
    flat_j = K * n + lo + (torch.ones_like(K) << K) - 1
    gs, ghs = gs.view(-1), ghs.view(-1)
    red = vop(gs[flat_i], gs[flat_j]).to(torch.float64)
    has = torch.maximum(ghs[flat_i], ghs[flat_j]) > 0
    return red, has


def window_function(table: Table, value_name: str, reduction: str,
                    preceding=None,
                    partition_by: Sequence[str] = (),
                    order_by: Sequence[str] = (),
                    frame: str = "rows") -> Column:
    """Rolling `reduction` over `value_name`, per partition, in sort order;
    the FLOAT64 result column `<value>_<reduction>` is aligned to the input
    rows. NULL values and dead rows are skipped; a frame with no valid row
    is NULL, except for `count`, which is valid everywhere.

    frame="rows": `preceding` rows up to the current one (None = every
    preceding row). frame="range": rows of the partition whose (single,
    numeric) order value lies in [current - preceding, current].

    ≅ gpu_window_function's intended contract (windowedops.cu:46-148)."""
    require(reduction in WINDOW_REDUCTIONS,
            GDFStatus.GDF_INVALID_AGGREGATOR, reduction)
    require(frame in ("rows", "range"), GDFStatus.GDF_INVALID_API_CALL,
            f"frame must be 'rows' or 'range', got {frame!r}")
    if frame == "range":
        require(len(order_by) == 1, GDFStatus.GDF_INVALID_API_CALL,
                "RANGE frames need exactly one order_by column")
        require(preceding is not None, GDFStatus.GDF_INVALID_API_CALL,
                "RANGE frames need a numeric `preceding` delta")
        require(float(preceding) >= 0, GDFStatus.GDF_INVALID_API_CALL,
                "RANGE preceding must be >= 0")
    n = table.capacity
    require(n > 0, GDFStatus.GDF_DATASET_EMPTY)
    col = table.column(value_name)
    dev = table.device

    fields = []
    if partition_by:
        fields.append((hash_columns([table.column(c)
                                     for c in partition_by]), 32))
    for name in order_by:
        data = table.column(name).data
        width = radix_width(data.dtype)
        fields.append((radix_bits(radix_encode(data, True), width), width))
    valid = col.valid_or_true()
    if table.num_rows is not None:
        valid = valid & table.live_mask()
    if fields:
        iota_bits = max(1, max(n - 1, 1).bit_length())
        words = pack_bit_fields(fields, iota_bits=iota_bits, n=n, device=dev)
        nk = len(words)
        res = multi_sort(words + [col.data, valid], num_keys=nk)
        s_words, vals, valid = res[:nk], res[nk], res[nk + 1]
        offs, _ = bit_field_offsets([f[1] for f in fields])
        perm = (s_words[-1] ^ SIGN) & ((1 << iota_bits) - 1)
    else:
        vals, perm = col.data, None

    seg_start = torch.zeros(n, dtype=torch.bool, device=dev)
    with host_sync("window.seg_start"):     # a blocking copy
        seg_start[0] = True
    if partition_by:
        sorted_part = unpack_bit_field(s_words, offs[0], 32)
        seg_start[1:] = sorted_part[1:] != sorted_part[:-1]

    if frame == "range":
        # frame_lo[i]: the first row of i's partition whose order value is
        # >= o[i] - preceding, by one lexicographic search over the sort the
        # rows already sit in. The sorted order values decode from the key
        # words; integer keys subtract floor(delta) in int64, clipped.
        odt = table.column(order_by[0]).data.dtype
        width = fields[-1][1]
        enc_o = radix_from_bits(
            unpack_bit_field(s_words, offs[-1], width), width)
        o_sorted = radix_decode(enc_o, odt)
        if o_sorted.is_floating_point():
            with host_sync("window.preceding"):    # a blocking copy
                delta = torch.tensor(preceding, dtype=odt, device=dev)
            q = o_sorted - delta
        else:
            info = torch.iinfo(odt)
            q = (o_sorted.to(torch.int64) - math.floor(preceding)).clamp(
                info.min, info.max).to(odt)
        skeys, qkeys = [enc_o], [radix_encode(q, True)]
        if partition_by:
            skeys.insert(0, sorted_part)
            qkeys.insert(0, sorted_part)
        frame_lo = lex_searchsorted(skeys, qkeys, "left")
        out_sorted, has = _windowed_range(vals, valid, seg_start, frame_lo,
                                          reduction)
    else:
        prec = n if preceding is None else int(preceding)
        require(prec >= 1, GDFStatus.GDF_INVALID_API_CALL,
                "preceding must be >= 1")
        out_sorted, has = _windowed(vals, valid, seg_start, prec, reduction)

    if perm is None:
        out, out_valid = out_sorted, has
    else:
        out = torch.empty_like(out_sorted)
        out_valid = torch.empty_like(has)
        out[perm] = out_sorted
        out_valid[perm] = has
    return Column(data=out, valid=out_valid,
                  info=DtypeInfo(GDFDtype.FLOAT64),
                  name=f"{value_name}_{reduction}")
