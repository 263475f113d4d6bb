"""Groupby / aggregate: sum, min, max, avg, count.

Counterpart of `libgdf_tpu/ops/groupby.py` (≅ gdf_group_by_{sum,min,max,
avg,count}, libgdf/src/sqls_ops.cu:1426-1487, and the sort path of
sqls_rtti_comp.hpp:400-660). Three paths, chosen from the input alone:

- the dense path, where every key is an integer column (int8 .. int64,
  date32, bool), no key is nullable under `dropna=False`, every aggregate
  is sum, count or avg, and the keys' live values span a domain of at
  most 8 slots with at most 8 accumulators a slot: a probe reads each
  key's min and max over the live rows whose keys are all valid (the
  group-by's one host read, `groupby.domain`), then H5 aggregates every
  row into its slot's accumulators in one pass (ops/kernels/dense.py);
- the wide path, for such an input whose domain is wider, where H7's slot
  arrays (the domain's slots x 4 bytes for the rows and 8 for each further
  accumulator) take no more bytes than the sort path's own per-row
  buffers would (`_sort_bytes`): after the same probe, H7 adds every row
  into slot arrays in device memory and compacts the occupied slots;
- the sort path, for every other input, with the JAX package's algorithm:

    sort:       key flags and encodings packed into 64-bit words; one
                stable sort carries every aggregated column along;
    boundaries: adjacent difference of the sorted key fields;
    scans:      per aggregate a segmented scan (H3), whose value at each
                group's last row is the aggregate;
    extract:    one compaction (H1) keeps the group-last rows; keys are
                decoded from the sorted words.

Each group-by counts its path (`groupby.dense` / `groupby.wide` /
`groupby.sort`) in `utils.tracing.counters()` and runs inside the span of
that name (`libgdf.groupby.dense`, ...). The sort path also adds its input
capacity to `groupby.sort.rows`, and splits its time after the sort
(`libgdf.sort`) into `libgdf.groupby.sort.scan` (the scans) and
`libgdf.groupby.sort.extract` (the boundaries, the key decode and the
compaction).
Output rows come sorted by key. Null semantics are the JAX package's
(pandas-like): `dropna=True` drops null-key rows, `dropna=False` makes each
null-key row a group of its own (NULL != NULL); aggregates skip null
values; COUNT counts the non-null values of its column. A denormal float
value is zero, as XLA reads it, in every aggregate: `sum` flushes inside
H3's load, `avg` flushes a float32 column before widening it to float64
(a float32 denormal is normal in float64), and float32 `min` / `max`
flush before their scans (float64 ones order through their encodings,
which read a denormal as zero).
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..core.bitmask import mask_or
from ..core.bits import flush_denormals, flush_float_keys, to_float64
from ..core.column import Column
from ..core.dtypes import DtypeInfo, GDFDtype, dtype_from_numpy
from ..core.errors import GDFStatus, require
from ..core.table import Table
from ..utils.tracing import count, host_sync, span, spanned
from .compaction import compact_arrays
from .engine import multi_sort, seg_scan_max, seg_scan_min, seg_scan_sum
from .kernels import dense
from .sort import (bit_field_offsets, pack_bit_fields, radix_bits,
                   radix_decode, radix_encode, radix_from_bits, radix_width,
                   unpack_bit_field)

AGG_OPS = ("sum", "min", "max", "avg", "count", "count_distinct")
_F64 = DtypeInfo(GDFDtype.FLOAT64)
_I64 = DtypeInfo(GDFDtype.INT64)
_SCAN = "libgdf.groupby.sort.scan"
_EXTRACT = "libgdf.groupby.sort.extract"


def _agg_identity(op: str, dtype: torch.dtype):
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


@spanned("libgdf.op.groupby")
def groupby(table: Table, key_names: Sequence[str], aggs: Sequence[tuple],
            dropna: bool = True) -> Table:
    """Group by key columns and aggregate.

    aggs: (column_name, op[, output_name]) with op in AGG_OPS. Returns a
    Table of the key columns and one column per aggregate, padded to the
    input capacity, with num_rows = number of groups, sorted by key."""
    require(len(key_names) > 0, GDFStatus.GDF_DATASET_EMPTY, "no keys")
    for a in aggs:
        require(a[1] in AGG_OPS, GDFStatus.GDF_INVALID_AGGREGATOR, a[1])
    return _groupby_impl(table, key_names, aggs, dropna)


def _groupby_impl(table: Table, key_names, aggs, dropna: bool) -> Table:
    key_cols = [table.column(k) for k in key_names]
    plan = _dense_plan(table, key_cols, aggs, dropna)
    if plan is not None:
        path = "groupby.wide" if plan.wide else "groupby.dense"
        count(path)
        with span("libgdf." + path):
            return _dense_groupby(plan, key_names, key_cols, aggs)
    count("groupby.sort")
    count("groupby.sort.rows", table.capacity)
    with span("libgdf.groupby.sort"):
        return _sort_groupby(table, key_names, key_cols, aggs, dropna)


def _sort_bytes(table: Table, key_cols, aggs) -> int:
    """Bytes of the sort path's own per-row buffers for an input the dense
    plan takes (no key nullable under dropna=False): its packed key words
    (with the dropped-row flag where there are null keys or dead rows) and
    their sorted copy, the int64 permutation, and each aggregated column
    (and its validity) sorted and scanned."""
    drop = (table.num_rows is not None
            or any(c.valid is not None for c in key_cols))
    bits = sum(radix_width(c.data.dtype) for c in key_cols) + drop
    per_row = 2 * 8 * -(-bits // 64) + 8
    for name in {spec[0] for spec in aggs}:
        col = table.column(name)
        per_row += 2 * (col.data.element_size() + (col.valid is not None))
    return table.capacity * per_row


def _dense_plan(table: Table, key_cols, aggs, dropna: bool):
    """The plan of the dense or the wide path where the input allows it,
    else None. An input that `dense.request` takes costs one probe and one
    host read, whichever path it takes."""
    names = {spec[0] for spec in aggs}
    plan = dense.request(
        [(c.data, c.valid) for c in key_cols],
        {n: (table.column(n).data, table.column(n).valid) for n in names},
        aggs, dropna, table.num_rows)
    if plan is None:
        return None
    bounds = dense.domain_probe(plan.keys, plan.row_ok, plan.num_rows)
    with host_sync("groupby.domain"):      # the group-by's one host read
        bounds = bounds.tolist()
    return plan.over(bounds, _sort_bytes(table, key_cols, aggs))


def _dense_groupby(plan, key_names, key_cols, aggs) -> Table:
    run = dense.wide_groupby if plan.wide else dense.dense_groupby
    outs, oks, live, groups = run(plan)
    cols = [Column(data=d, valid=None if c.valid is None else live,
                   info=c.info, name=name)
            for name, c, d in zip(key_names, key_cols, outs)]
    for spec, d, ok in zip(aggs, outs[len(key_cols):], oks[len(key_cols):]):
        op = spec[1]
        info = {"count": _I64, "avg": _F64}.get(op) or DtypeInfo(
            dtype_from_numpy(d.dtype))
        cols.append(Column(data=d, valid=live if ok is None else ok,
                           info=info,
                           name=spec[2] if len(spec) > 2
                           else f"{op}_{spec[0]}"))
    return Table.from_columns(cols, num_rows=groups)


def _sort_groupby(table: Table, key_names, key_cols, aggs,
                  dropna: bool) -> Table:
    n = table.capacity
    dev = table.device

    # Dropped rows sort last; with dropna=False each null-key row is its
    # own group (gdf_table.cuh:588-591).
    null_key = None
    for c in key_cols:
        if c.valid is not None:
            null_key = mask_or(null_key, ~c.valid)
    drop = null_key if dropna else None
    if table.num_rows is not None:
        drop = mask_or(drop, ~table.live_mask())

    widths, fields, key_field_idx = [], [], []
    key_nullable = [(not dropna and c.valid is not None) for c in key_cols]
    if drop is not None:
        fields.append((drop.to(torch.int64), 1))
    for j, c in enumerate(key_cols):
        data = c.data
        if data.is_floating_point():
            data = flush_float_keys(data)
        w = radix_width(data.dtype)
        widths.append(w)
        if key_nullable[j]:
            # the null flag sorts inside the key word, just above the key
            fields.append(((~c.valid).to(torch.int64), 1))
        key_field_idx.append(len(fields))
        fields.append((radix_bits(radix_encode(data), w), w))
    words = pack_bit_fields(fields)
    nk = len(words)

    operands = list(words)
    agg_slots = {}
    for spec in aggs:
        col_name = spec[0]
        if col_name in agg_slots:
            continue
        acol = table.column(col_name)
        operands.append(acol.data)
        dslot = len(operands) - 1
        vslot = None
        if acol.valid is not None:
            operands.append(acol.valid)
            vslot = len(operands) - 1
        agg_slots[col_name] = (dslot, vslot)
    res = multi_sort(operands, num_keys=nk)

    with span(_EXTRACT):
        s_words = res[:nk]
        offs, _ = bit_field_offsets([f[1] for f in fields])
        if drop is not None:
            s_dropped = unpack_bit_field(s_words, offs[0], 1) != 0
        else:
            s_dropped = torch.zeros(n, dtype=torch.bool, device=dev)
        s_enc = [radix_from_bits(unpack_bit_field(
            s_words, offs[key_field_idx[j]], widths[j]), widths[j])
            for j in range(len(key_cols))]
        s_key_null = {j: unpack_bit_field(
            s_words, offs[key_field_idx[j] - 1], 1) != 0
            for j in range(len(key_cols)) if key_nullable[j]}

        # Group boundaries (≅ reduce_by_key's equality predicate).
        new_group = torch.zeros(n, dtype=torch.bool, device=dev)
        new_group[:1].fill_(True)          # on the device: no host copy
        for k in s_enc:
            new_group[1:] |= k[1:] != k[:-1]
        if s_key_null:
            s_null = torch.zeros(n, dtype=torch.bool, device=dev)
            for flag in s_key_null.values():
                s_null = s_null | flag
            # a null-key row always starts and ends its own group
            new_group = new_group | s_null
            new_group[1:] |= s_null[:-1]

        scan_starts = new_group | s_dropped
        is_last = torch.cat([scan_starts[1:],
                             torch.ones(1, dtype=torch.bool, device=dev)])[:n]
        keep = is_last & ~s_dropped
        num_groups = keep.sum(dtype=torch.int32)
        group_live = (torch.arange(n, dtype=torch.int32, device=dev)
                      < num_groups)

        out_arrays, builders = [], []

        def add_out(arrs, build):
            out_arrays.append(arrs)
            builders.append(build)

        for j, (name, c, enc) in enumerate(zip(key_names, key_cols, s_enc)):
            has_null_flag = j in s_key_null

            def build_key(xs, c=c, kv=has_null_flag, name=name):
                if kv:
                    valid = xs[1] & group_live
                else:
                    valid = None if c.valid is None else group_live
                return Column(data=xs[0], valid=valid, info=c.info, name=name)

            arrs = [radix_decode(enc, c.data.dtype)]
            if has_null_flag:
                arrs.append(~s_key_null[j])
            add_out(arrs, build_key)

    # AVG from sibling SUM and COUNT of the same column (≅ multi_pass_avg
    # reusing its results, groupby.cuh:308-419): no scans of its own; the
    # divide runs after the extraction.
    sums = {s[0]: (s[2] if len(s) > 2 else f"sum_{s[0]}")
            for s in aggs if s[1] == "sum"}
    counts = {s[0]: (s[2] if len(s) > 2 else f"count_{s[0]}")
              for s in aggs if s[1] == "count"}
    deferred_avg = {}

    with span(_SCAN):
        for spec in aggs:
            col_name, op = spec[0], spec[1]
            out_name = spec[2] if len(spec) > 2 else f"{op}_{col_name}"
            if op == "avg" and col_name in sums and col_name in counts:
                deferred_avg[len(builders)] = (out_name, sums[col_name],
                                               counts[col_name])
                add_out([], None)
                continue
            dslot, vslot = agg_slots[col_name]
            avalid = None if vslot is None else res[vslot]
            arrs, build = _scan_agg(res[dslot], avalid, scan_starts, op,
                                    group_live, out_name)
            add_out(arrs, build)

    with span(_EXTRACT):
        flat = [a for arrs in out_arrays for a in arrs]
        compacted, _ = compact_arrays(flat, keep)
        cols, i = [], 0
        for arrs, build in zip(out_arrays, builders):
            cnt = len(arrs)
            cols.append(None if build is None
                        else build(compacted[i:i + cnt]))
            i += cnt
        by_name = {c.name: c for c in cols if c is not None}
        for pos, (out_name, s_name, c_name) in deferred_avg.items():
            scol, ccol = by_name[s_name], by_name[c_name]
            data = (flush_denormals(scol.data).to(torch.float64)
                    / ccol.data.clamp(min=1).to(torch.float64))
            valid = group_live & (ccol.data > 0)
            if scol.valid is not None:
                valid = valid & scol.valid
            cols[pos] = Column(data=data, valid=valid, info=_F64,
                               name=out_name)
    return Table.from_columns(cols, num_rows=num_groups)


def _scan_agg(vals, avalid, starts, op, group_live, out_name):
    """Per-row segmented scans whose group-last values are the aggregates
    (≅ thrust::reduce_by_key, sqls_rtti_comp.hpp:468-509). Returns (arrays
    to extract, builder)."""
    if op in ("count", "count_distinct"):
        ones = (torch.ones_like(vals, dtype=torch.int32) if avalid is None
                else avalid.to(torch.int32))
        cnt = seg_scan_sum(ones, starts)

        def build_count(xs):
            return Column(data=xs[0].to(torch.int64), valid=group_live,
                          info=_I64, name=out_name)
        return [cnt], build_count

    if op == "avg":
        # ≅ multi_pass_avg (groupby.cuh:308-419): float64 sum and count.
        fvals = to_float64(vals)            # float64 flushes inside H3
        if avalid is not None:
            fvals = torch.where(avalid, fvals, 0.0)
            ones = avalid.to(torch.int32)
        else:
            ones = torch.ones_like(vals, dtype=torch.int32)
        tot = seg_scan_sum(fvals, starts)
        cnt = seg_scan_sum(ones, starts)
        avg = tot / cnt.clamp(min=1)
        if avalid is None:
            def build_avg0(xs):
                return Column(data=xs[0], valid=group_live, info=_F64,
                              name=out_name)
            return [avg], build_avg0

        def build_avg(xs):
            return Column(data=xs[0], valid=group_live & xs[1], info=_F64,
                          name=out_name)
        return [avg, cnt > 0], build_avg

    if op != "sum" and vals.dtype != torch.float64:
        # a denormal is zero (float64 min / max flush through their int64
        # encodings, engine._seg_select; a sum flushes inside H3)
        vals = flush_denormals(vals)
    if avalid is not None:
        vals = torch.where(avalid, vals, _agg_identity(op, vals.dtype))
    if op == "sum":
        out = seg_scan_sum(vals, starts)
    elif op == "min":
        out = seg_scan_min(vals, starts)
    else:
        out = seg_scan_max(vals, starts)
    info = DtypeInfo(dtype_from_numpy(out.dtype))
    if avalid is None:
        def build0(xs):
            return Column(data=xs[0], valid=group_live, info=info,
                          name=out_name)
        return [out], build0
    okay = seg_scan_sum(avalid.to(torch.int32), starts) > 0

    def build(xs):
        return Column(data=xs[0], valid=group_live & xs[1], info=info,
                      name=out_name)
    return [out, okay], build


def count_distinct_keys(table: Table, key_names: Sequence[str],
                        dropna: bool = True):
    """0-d count of distinct key tuples.

    ≅ GDF_COUNT_DISTINCT collapsing to a single value
    (sqls_rtti_comp.hpp:400-441 DISTINCT branch)."""
    g = groupby(table, key_names,
                aggs=[(key_names[0], "count", "_c")], dropna=dropna)
    return g.num_rows


def group_by_sum(table, keys, agg_col):
    """≅ gdf_group_by_sum (sqls_ops.cu:1426-1436)."""
    return groupby(table, keys, [(agg_col, "sum", "out")])


def group_by_min(table, keys, agg_col):
    return groupby(table, keys, [(agg_col, "min", "out")])


def group_by_max(table, keys, agg_col):
    return groupby(table, keys, [(agg_col, "max", "out")])


def group_by_avg(table, keys, agg_col):
    return groupby(table, keys, [(agg_col, "avg", "out")])


def group_by_count(table, keys):
    return groupby(table, keys, [(keys[0], "count", "out")])
