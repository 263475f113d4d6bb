"""The flat gdf_* function surface.

Counterpart of `libgdf_tpu/compat/gdf.py`, name for name: one Python
callable per public entry point of the reference C ABI
(libgdf/include/gdf/cffi/functions.h — every `gdf_error gdf_*(...)` and
`gpu_*(...)` declaration), implemented over this package's ops layer.

Mapping conventions:
  - `gdf_column*` in/out parameters become immutable `Column` values:
    output-parameter functions RETURN the new Column instead of mutating.
  - `gdf_error` returns become exceptions (`GDFError`) — exactly the
    translation the reference's own Python binding performs
    (python/libgdf_cffi/wrapper.py:20-28 raises GDFError on nonzero).
  - typed variants (`gdf_add_i32` …) validate dtype then dispatch to the
    same vectorized op as `_generic` — the reference needed per-type
    symbols for C; here they are dtype guards.
  - scalar "dev_result" outputs (reductions) are 0-d tensors on the
    column's device.
  - plan-based radix sorts keep their plan-object lifecycle for API
    parity, but plans hold no scratch (torch.sort owns its own).
  - host data (numpy) handed to `gdf_column_view*` goes to the card and
    raises without CUDA unless `device="cpu"` is passed; tensors stay
    where they are. Entries that return compacted columns read the count
    on the host, so they synchronize.
"""
from __future__ import annotations

import torch

from .. import ops
from ..core.bitmask import (
    all_bitmask_on, count_valid, mask_and, mask_concat, num_bitmask_bytes,
    unpack_bitmask,
)
from ..core.column import Column, as_tensor, column_concat
from ..core.context import Context, Method, context_view  # noqa: F401
from ..core.dtypes import (DtypeInfo, GDFDtype, WindowFunctionType,
                           WindowReductionType, byte_width)
from ..core.errors import GDFError, GDFStatus, error_get_name, require
from ..core.table import Table
from ..utils.tracing import (host_sync, range_pop, range_push,
                             range_push_hex)

__all__ = []  # populated at bottom


def _expose(fn, name=None):
    name = name or fn.__name__
    globals()[name] = fn
    __all__.append(name)
    return fn


# ---------------------------------------------------------------------------
# Column management (src/column.cpp)
# ---------------------------------------------------------------------------

def gdf_column_view(data, valid=None, size=None, dtype=None,
                    device=None) -> Column:
    """≅ gdf_column_view (src/column.cpp:175-186): wrap buffers as a
    column. `valid` may be a packed uint8 bitmask or a bool vector."""
    return gdf_column_view_augmented(data, valid, size, dtype,
                                     null_count=None, device=device)


def gdf_column_view_augmented(data, valid=None, size=None, dtype=None,
                              null_count=None, device=None) -> Column:
    """≅ gdf_column_view_augmented (src/column.cpp:191-204). null_count is
    recomputed (the engine never trusts a stale count). numpy data goes to
    `device`, by default the card; a tensor stays on its device."""
    data = as_tensor(data, device)
    if size is not None:
        require(int(size) == data.shape[0], GDFStatus.GDF_COLUMN_SIZE_MISMATCH,
                f"size {size} != buffer rows {data.shape[0]}")
    if valid is not None:
        valid = as_tensor(valid, data.device)
        if valid.dtype == torch.uint8:
            valid = unpack_bitmask(valid, data.shape[0])
    return Column.from_array(data, valid=valid, gdf_dtype=dtype)


def gdf_column_free(col) -> None:
    """≅ gdf_column_free (src/column.cpp:222-227). A tensor's memory goes
    back to torch's allocator when its last reference drops — this is a
    no-op kept for ABI parity."""
    return None


def gdf_column_concat(columns) -> Column:
    """≅ gdf_column_concat (src/column.cpp:53-153) incl. the bitmask merge
    (gdf_mask_concat)."""
    return column_concat(columns)


def get_column_byte_width(col: Column) -> int:
    """≅ get_column_byte_width (src/column.cpp:237-275)."""
    return byte_width(col.info.gdf_dtype)


def gdf_column_sizeof() -> int:
    """≅ gdf_column_sizeof: size of the reference's gdf_column struct
    (pointer+pointer+int+enum+extra-info). Kept for ABI introspection."""
    return 40


for _f in (gdf_column_view, gdf_column_view_augmented, gdf_column_free,
           gdf_column_concat, get_column_byte_width, gdf_column_sizeof):
    _expose(_f)


# ---------------------------------------------------------------------------
# Errors / context / tracing (src/errorhandling.cpp, context.cpp, nvtx)
# ---------------------------------------------------------------------------

_expose(error_get_name, "gdf_error_get_name")
_expose(context_view, "gdf_context_view")
_expose(range_push, "gdf_nvtx_range_push")
_expose(range_push_hex, "gdf_nvtx_range_push_hex")
_expose(range_pop, "gdf_nvtx_range_pop")


def gdf_cuda_last_error() -> int:
    """≅ gdf_cuda_last_error (src/cudautils.cu:4-14). torch and the kernel
    wrappers raise Python exceptions instead of keeping a sticky error
    state; always success."""
    return 0


def gdf_cuda_error_string(err: int) -> str:
    return "no error" if err == 0 else f"error {err}"


def gdf_cuda_error_name(err: int) -> str:
    return "Success" if err == 0 else f"Error{err}"


for _f in (gdf_cuda_last_error, gdf_cuda_error_string, gdf_cuda_error_name):
    _expose(_f)


# ---------------------------------------------------------------------------
# Unary ops (src/unaryops.cu) — typed variants are dtype guards
# ---------------------------------------------------------------------------

_UNARY_OPS = ("sin", "cos", "tan", "asin", "acos", "atan", "exp", "log",
              "sqrt", "ceil", "floor")
_F_SUFFIX = {"f32": torch.float32, "f64": torch.float64}


def _typed_unary(op, suffix, want):
    def fn(input: Column) -> Column:
        require(input.data.dtype == want, GDFStatus.GDF_UNSUPPORTED_DTYPE,
                f"gdf_{op}_{suffix} wants {want}")
        return ops.unary_op(input, op)
    fn.__name__ = f"gdf_{op}_{suffix}"
    fn.__doc__ = (f"≅ gdf_{op}_{suffix} (src/unaryops.cu:92-130 "
                  "macro-generated dispatch)")
    return fn


for _op in _UNARY_OPS:
    _expose(lambda input, _op=_op: ops.unary_op(input, _op),
            f"gdf_{_op}_generic")
    for _sfx, _dt in _F_SUFFIX.items():
        _expose(_typed_unary(_op, _sfx, _dt))


# ---------------------------------------------------------------------------
# Cast matrix (src/unaryops.cu 9x9 incl. date/timestamp unit scaling)
# ---------------------------------------------------------------------------

_CAST_TARGETS = {
    "i8": GDFDtype.INT8, "i32": GDFDtype.INT32, "i64": GDFDtype.INT64,
    "f32": GDFDtype.FLOAT32, "f64": GDFDtype.FLOAT64,
    "date32": GDFDtype.DATE32, "date64": GDFDtype.DATE64,
    "timestamp": GDFDtype.TIMESTAMP,
}
_CAST_SOURCES = dict(_CAST_TARGETS)


def _typed_cast(src_name, dst_name, dst_dtype):
    def fn(input: Column, time_unit=None) -> Column:
        return ops.cast(input, dst_dtype, time_unit=time_unit)
    fn.__name__ = f"gdf_cast_{src_name}_to_{dst_name}"
    fn.__doc__ = ("≅ gdf_cast_* (src/unaryops.cu cast matrix incl. "
                  "date32/64<->timestamp unit scaling :200-497)")
    return fn


for _s in _CAST_SOURCES:
    for _d, _ddt in _CAST_TARGETS.items():
        _expose(_typed_cast(_s, _d, _ddt))
    _expose(_typed_cast("generic", _s, _CAST_TARGETS[_s]))


# ---------------------------------------------------------------------------
# Binary ops (src/binaryops.cu) — output valid where BOTH inputs valid
# ---------------------------------------------------------------------------

_BINARY_SUFFIXES = {
    "add": ("i32", "i64", "f32", "f64"),
    "sub": ("i32", "i64", "f32", "f64"),
    "mul": ("i32", "i64", "f32", "f64"),
    "floordiv": ("i32", "i64", "f32", "f64"),
    "div": ("f32", "f64"),
    "gt": ("i8", "i32", "i64", "f32", "f64"),
    "ge": ("i8", "i32", "i64", "f32", "f64"),
    "lt": ("i8", "i32", "i64", "f32", "f64"),
    "le": ("i8", "i32", "i64", "f32", "f64"),
    "eq": ("i8", "i32", "i64", "f32", "f64"),
    "ne": ("i8", "i32", "i64", "f32", "f64"),
    "bitwise_and": ("i8", "i32", "i64"),
    "bitwise_or": ("i8", "i32", "i64"),
    "bitwise_xor": ("i8", "i32", "i64"),
}
_SFX_DTYPE = {"i8": torch.int8, "i32": torch.int32, "i64": torch.int64,
              "f32": torch.float32, "f64": torch.float64}


def _typed_binary(op, suffix):
    want = _SFX_DTYPE[suffix]

    def fn(lhs: Column, rhs: Column) -> Column:
        require(lhs.data.dtype == want, GDFStatus.GDF_UNSUPPORTED_DTYPE,
                f"gdf_{op}_{suffix} wants {want}")
        return ops.binary_op(lhs, rhs, op)
    fn.__name__ = f"gdf_{op}_{suffix}"
    fn.__doc__ = f"≅ gdf_{op}_{suffix} (src/binaryops.cu:9-31 kernel)"
    return fn


for _op, _sfxs in _BINARY_SUFFIXES.items():
    _expose(lambda lhs, rhs, _op=_op: ops.binary_op(lhs, rhs, _op),
            f"gdf_{_op}_generic")
    for _sfx in _sfxs:
        _expose(_typed_binary(_op, _sfx))


def gdf_validity_and(lhs: Column, rhs: Column) -> Column:
    """≅ gdf_validity_and: output column whose mask is the AND of the two
    input masks (src/binaryops.cu + validops)."""
    return Column(data=torch.zeros(lhs.size, dtype=torch.int8,
                                   device=lhs.device),
                  valid=mask_and(lhs.valid, rhs.valid),
                  info=DtypeInfo(GDFDtype.INT8), name="")


_expose(gdf_validity_and)


# ---------------------------------------------------------------------------
# Filter/compare ops (src/filterops.cu)
# ---------------------------------------------------------------------------

def _typed_cmp_static(suffix):
    want = _SFX_DTYPE.get(suffix, {"i16": torch.int16}.get(suffix))

    def fn(lhs: Column, value, operation) -> Column:
        require(lhs.data.dtype == want, GDFStatus.GDF_UNSUPPORTED_DTYPE,
                f"gpu_comparison_static_{suffix} wants {want}")
        return ops.compare_scalar(lhs, value, operation)
    fn.__name__ = f"gpu_comparison_static_{suffix}"
    fn.__doc__ = ("≅ gpu_comparison_static_* (src/filterops.cu:17-95): "
                  "column vs scalar -> int8 stencil")
    return fn


for _sfx in ("i8", "i16", "i32", "i64", "f32", "f64"):
    _expose(_typed_cmp_static(_sfx))

_expose(lambda lhs, rhs, operation: ops.compare(lhs, rhs, operation),
        "gpu_comparison")


# ---------------------------------------------------------------------------
# Stream compaction / concat (src/streamcompactionops.cu)
# ---------------------------------------------------------------------------

def gpu_apply_stencil(lhs: Column, stencil: Column) -> Column:
    """≅ gpu_apply_stencil (src/streamcompactionops.cu:163-260): keep rows
    where stencil != 0 AND stencil valid; returns the compacted column."""
    out, count = ops.apply_stencil(lhs, stencil)
    with host_sync("stencil.count"):
        n = int(count)
    return Column(data=out.data[:n],
                  valid=None if out.valid is None else out.valid[:n],
                  info=out.info, name=out.name)


def gpu_concat(lhs: Column, rhs: Column) -> Column:
    """≅ gpu_concat (src/streamcompactionops.cu:389-503) incl. bit-level
    bitmask stitching (trivial on unpacked masks)."""
    return column_concat([lhs, rhs])


_expose(gpu_apply_stencil)
_expose(gpu_concat)


# ---------------------------------------------------------------------------
# Validity / bitmask ops (src/validops.cu, bitmaskops.cu)
# ---------------------------------------------------------------------------

def gdf_count_nonzero_mask(col_or_mask, num_rows=None, device=None):
    """≅ gdf_count_nonzero_mask (src/validops.cu:84-196): a 0-d int32
    tensor beside the mask."""
    if isinstance(col_or_mask, Column):
        return count_valid(col_or_mask.valid, col_or_mask.size,
                           col_or_mask.device)
    m = as_tensor(col_or_mask, device)
    if m.dtype == torch.uint8:
        m = unpack_bitmask(m, num_rows)
    return count_valid(m, num_rows if num_rows is not None else m.shape[0])


def gdf_mask_concat(masks, lengths):
    """≅ gdf_mask_concat (src/validops.cu:203-258)."""
    return mask_concat(masks, lengths)


_expose(gdf_count_nonzero_mask)
_expose(gdf_mask_concat)
_expose(all_bitmask_on, "all_bitmask_on")
_expose(lambda a, b: mask_and(a, b), "apply_bitmask_to_bitmask")
_expose(num_bitmask_bytes, "gdf_get_num_chars_bitmask")


# ---------------------------------------------------------------------------
# Datetime extract (src/datetimeops.cu)
# ---------------------------------------------------------------------------

for _part in ("year", "month", "day", "hour", "minute", "second"):
    _expose(getattr(ops, f"extract_{_part}"),
            f"gdf_extract_datetime_{_part}")


# ---------------------------------------------------------------------------
# Reductions (src/reductions.cu) + prefix sum (src/scan.cu)
# ---------------------------------------------------------------------------

def gdf_reduce_optimal_output_size() -> int:
    """≅ gdf_reduce_optimal_output_size (functions.h:632, reductions.cu:9).
    The CUDA two-round reduction needed a 128-slot scratch; a torch
    reduction needs none — the constant is kept so callers can size
    buffers identically."""
    return 128


_expose(gdf_reduce_optimal_output_size)

_RED_OPS = {"sum": ops.sum, "min": ops.min, "max": ops.max,
            "product": ops.product, "sum_squared": ops.sum_of_squares}


def _typed_reduction(op, fn_impl, suffix):
    want = _SFX_DTYPE[suffix]

    def fn(col: Column, dev_result=None, dev_result_size=None):
        require(col.data.dtype == want, GDFStatus.GDF_UNSUPPORTED_DTYPE,
                f"gdf_{op}_{suffix} wants {want}")
        return fn_impl(col)
    fn.__name__ = f"gdf_{op}_{suffix}"
    fn.__doc__ = (f"≅ gdf_{op}_{suffix} (src/reductions.cu:24-127 "
                  "two-round block reduce; invalid lanes -> identity)")
    return fn


for _op, _impl in _RED_OPS.items():
    _expose(lambda col, dev_result=None, dev_result_size=None, _i=_impl:
            _i(col), f"gdf_{_op}_generic")
    _sfxs = (("f32", "f64") if _op == "sum_squared"
             else ("i8", "i32", "i64", "f32", "f64"))
    for _sfx in _sfxs:
        _expose(_typed_reduction(_op, _impl, _sfx))


def _typed_prefixsum(suffix, want):
    def fn(inp: Column, inclusive: bool = True) -> Column:
        require(inp.data.dtype == want, GDFStatus.GDF_UNSUPPORTED_DTYPE,
                f"gdf_prefixsum_{suffix} wants {want}")
        return ops.prefixsum(inp, inclusive=inclusive)
    fn.__name__ = f"gdf_prefixsum_{suffix}"
    fn.__doc__ = "≅ gdf_prefixsum_* (src/scan.cu:11-76, CUB DeviceScan)"
    return fn


_expose(lambda inp, inclusive=True: ops.prefixsum(inp, inclusive=inclusive),
        "gdf_prefixsum_generic")
for _sfx in ("i8", "i32", "i64"):
    _expose(_typed_prefixsum(_sfx, _SFX_DTYPE[_sfx]))


# ---------------------------------------------------------------------------
# Hashing (src/hashing.cu, hashops.cu)
# ---------------------------------------------------------------------------

def gdf_hash(num_cols, input_columns, hash_fn="murmur3"):
    """≅ gdf_hash (src/hashing.cu:83-150): row-hash column (int32-backed
    u32 bits)."""
    cols = list(input_columns)[:num_cols]
    t = Table.from_columns(cols)
    return ops.hash_table_rows(t, num_cols, hash_fn)


def gpu_hash_columns(columns_to_hash, num_columns=None):
    """≅ gpu_hash_columns (src/hashops.cu:25-120): row-wise 64-bit FNV-1a
    over the columns' bytes (bit-exact, incl. the reference's
    sign-extended-char xor), stored in an INT64-backed column with an
    all-on validity mask ANDed with the inputs' masks (hashops.cu:128+)."""
    cols = list(columns_to_hash)
    if num_columns is not None:
        cols = cols[:num_columns]
    h = ops.fnv1a_64_columns(cols)
    valid = None
    for c in cols:
        if isinstance(c, Column) and c.valid is not None:
            valid = c.valid if valid is None else (valid & c.valid)
    # fnv1a_64_columns returns the uint64 words' bits as int64 already
    return Column(data=h, valid=valid,
                  info=DtypeInfo(GDFDtype.INT64), name="hash")


def gdf_hash_partition(num_input_cols, input_columns, columns_to_hash,
                       num_partitions, hash_fn="murmur3"):
    """≅ gdf_hash_partition (src/hashing.cu:559-654). `columns_to_hash`
    are indices into `input_columns`. Returns (partitioned columns list,
    offsets int32[num_partitions])."""
    cols = list(input_columns)[:num_input_cols]
    named = [c.with_name(c.name or f"c{i}") for i, c in enumerate(cols)]
    t = Table.from_columns(named)
    keys = [t.names[i] for i in columns_to_hash]
    out, offsets = ops.hash_partition(t, keys, num_partitions, hash_fn)
    return list(out.columns), offsets


for _f in (gdf_hash, gpu_hash_columns, gdf_hash_partition):
    _expose(_f)


# ---------------------------------------------------------------------------
# Joins (src/join/joining.cu) and order-by/filter/groupby (src/sqls_ops.cu)
# ---------------------------------------------------------------------------

def _join_entry(how):
    def fn(left_cols, num_left_cols, left_join_cols,
           right_cols, num_right_cols, right_join_cols,
           num_cols_to_join, result_num_cols=None, context=None):
        lcols = [c.with_name(c.name or f"l{i}")
                 for i, c in enumerate(list(left_cols)[:num_left_cols])]
        rcols = [c.with_name(c.name or f"r{i}")
                 for i, c in enumerate(list(right_cols)[:num_right_cols])]
        lt, rt = Table.from_columns(lcols), Table.from_columns(rcols)
        lon = [lt.names[i] for i in left_join_cols[:num_cols_to_join]]
        ron = [rt.names[i] for i in right_join_cols[:num_cols_to_join]]
        out = ops.join(lt, rt, lon, ron, how=how).compact()
        return list(out.columns)
    fn.__name__ = f"gdf_{how}_join"
    fn.__doc__ = (f"≅ gdf_{how}_join (src/join/joining.cu:571-653) -> "
                  "result dataframe columns (construct_join_output_df, "
                  ":375-479)")
    return fn


for _how in ("inner", "left", "full"):
    _expose(_join_entry(_how))


def gdf_order_by(input_columns, num_inputs=None, context=None,
                 ascending=True, nulls_last=True):
    """≅ gdf_order_by (src/sqls_ops.cu:1373-1392): returns the sorted-order
    permutation as an int32 index column."""
    cols = list(input_columns)
    if num_inputs is not None:
        cols = cols[:num_inputs]
    named = [c.with_name(c.name or f"c{i}") for i, c in enumerate(cols)]
    t = Table.from_columns(named)
    perm = ops.order_by(t, list(t.names), ascending, nulls_last)
    return Column.from_array(perm, name="indices")


def _window_enum(enum_type, value, what):
    """An ABI enum member from its value or its name (without the
    GDF_WINDOW_ prefix, any case); GDF_INVALID_API_CALL for neither."""
    try:
        if isinstance(value, str):
            return enum_type[f"GDF_WINDOW_{value.upper()}"]
        return enum_type(value)
    except (KeyError, ValueError):
        raise GDFError(GDFStatus.GDF_INVALID_API_CALL,
                       f"unknown window {what} {value!r}") from None


def gdf_window_function(value_column, reduction, frame,
                        preceding=None, partition_columns=(),
                        order_columns=()):
    """≅ the contract gpu_window_function declared but never shipped
    (src/windowedops.cu:46-148, compiled out — CMakeLists.txt:154; the
    ABI enums window_function_type / window_reduction_type are
    types.h:197-210). Accepts the ABI enum values or their names.

    Returns a FLOAT64 result column aligned to the input row order."""
    red = _window_enum(WindowReductionType, reduction, "reduction")
    frm = _window_enum(WindowFunctionType, frame, "frame")
    red_name = red.name.replace("GDF_WINDOW_", "").lower()
    frame_name = ("range" if frm == WindowFunctionType.GDF_WINDOW_RANGE
                  else "rows")
    # reserved internal names: user column names (or defaults) colliding
    # across the three roles would silently bind the wrong column
    cols = [value_column.with_name("__wv")]
    pnames, onames = [], []
    for i, c in enumerate(partition_columns):
        cols.append(c.with_name(f"__wp{i}"))
        pnames.append(cols[-1].name)
    for i, c in enumerate(order_columns):
        cols.append(c.with_name(f"__wo{i}"))
        onames.append(cols[-1].name)
    t = Table.from_columns(cols)
    out = ops.window_function(t, "__wv", red_name,
                              preceding=preceding, partition_by=pnames,
                              order_by=onames, frame=frame_name)
    return out.with_name(
        f"{value_column.name or 'value'}_{red_name}")


def gdf_filter(input_columns, value_tuple, num_inputs=None):
    """≅ gdf_filter (src/sqls_ops.cu:1401-1424): rows where EVERY column
    equals its value in the tuple (multi_col_filter,
    sqls_rtti_comp.hpp:343-370). Returns compacted output columns."""
    cols = list(input_columns)
    if num_inputs is not None:
        cols = cols[:num_inputs]
    named = [c.with_name(c.name or f"c{i}") for i, c in enumerate(cols)]
    t = Table.from_columns(named)
    keep = None
    for c, v in zip(named, value_tuple):
        s = ops.compare_scalar(c, v, "eq")
        ok = (s.data != 0)
        if s.valid is not None:
            ok = ok & s.valid
        keep = ok if keep is None else keep & ok
    stencil = Column.from_array(keep.to(torch.int8))
    out = ops.filter_table(t, stencil).compact()
    return list(out.columns)


_expose(gdf_order_by)
_expose(gdf_filter)


def _groupby_entry(op):
    def fn(num_key_cols, key_columns, agg_column=None, context=None,
           sort_result=True):
        kcols = [c.with_name(c.name or f"k{i}")
                 for i, c in enumerate(list(key_columns)[:num_key_cols])]
        t = Table.from_columns(
            kcols + ([agg_column.with_name("__agg")] if agg_column is not None
                     else []))
        aggs = [("__agg" if agg_column is not None else t.names[0],
                 op, "__out")]
        out = ops.groupby(t, [c.name for c in kcols], aggs).compact()
        keys_out = [out[c.name] for c in kcols]
        return keys_out, out["__out"]
    fn.__name__ = f"gdf_group_by_{op if op != 'avg' else 'avg'}"
    fn.__doc__ = (f"≅ gdf_group_by_{op} (src/sqls_ops.cu:1426-1487) — "
                  "SORT and HASH methods collapse to one implementation "
                  "(result sorted by key, ≅ ctx->flag_sort_result)")
    return fn


for _op in ("sum", "min", "max", "avg", "count"):
    _expose(_groupby_entry(_op))


# ---------------------------------------------------------------------------
# Radix sort plans (src/sorting.cu, segmented_sorting.cu)
# ---------------------------------------------------------------------------

class gdf_radixsort_plan_type:
    """≅ the opaque plan handle (types.h:172). Holds only the sort config:
    the reference's back-buffers (sorting.cu:31-44) are torch.sort's own
    scratch here."""

    def __init__(self, num_items, descending, begin_bit, end_bit):
        self.num_items = num_items
        self.descending = bool(descending)
        self.begin_bit = begin_bit
        self.end_bit = end_bit
        self.ready = False


def gdf_radixsort_plan(num_items, descending, begin_bit=0, end_bit=0):
    """≅ gdf_radixsort_plan (src/sorting.cu:148-153)."""
    return gdf_radixsort_plan_type(num_items, descending, begin_bit,
                                   end_bit or None)


def gdf_radixsort_plan_setup(plan, sizeof_key=None, sizeof_val=None):
    """≅ gdf_radixsort_plan_setup (src/sorting.cu:155-160)."""
    plan.ready = True
    return plan


def gdf_radixsort_plan_free(plan):
    """≅ gdf_radixsort_plan_free (src/sorting.cu:162-167)."""
    plan.ready = False
    return None


def _radixsort_entry(suffix, want):
    def fn(plan, keycol: Column, valcol: Column | None = None):
        require(plan.ready, GDFStatus.GDF_INVALID_API_CALL,
                "radixsort plan not set up")
        if want is not None:
            require(keycol.data.dtype == want,
                    GDFStatus.GDF_UNSUPPORTED_DTYPE,
                    f"gdf_radixsort_{suffix} wants {want}")
        return ops.radixsort(keycol, valcol, descending=plan.descending,
                             begin_bit=plan.begin_bit,
                             end_bit=plan.end_bit)
    fn.__name__ = f"gdf_radixsort_{suffix}"
    fn.__doc__ = ("≅ gdf_radixsort_* (src/sorting.cu:48-135, CUB "
                  "DeviceRadixSort::SortPairs)")
    return fn


for _sfx in ("i8", "i32", "i64", "f32", "f64"):
    _expose(_radixsort_entry(_sfx, _SFX_DTYPE[_sfx]))
_expose(_radixsort_entry("generic", None))
for _f in (gdf_radixsort_plan, gdf_radixsort_plan_setup,
           gdf_radixsort_plan_free):
    _expose(_f)


class gdf_segmented_radixsort_plan_type(gdf_radixsort_plan_type):
    """≅ the segmented plan handle (types.h:173)."""


def gdf_segmented_radixsort_plan(num_items, descending, begin_bit=0,
                                 end_bit=0):
    """≅ gdf_segmented_radixsort_plan (src/segmented_sorting.cu:171-261)."""
    return gdf_segmented_radixsort_plan_type(num_items, descending,
                                             begin_bit, end_bit or None)


_expose(gdf_segmented_radixsort_plan)
_expose(gdf_radixsort_plan_setup, "gdf_segmented_radixsort_plan_setup")
_expose(gdf_radixsort_plan_free, "gdf_segmented_radixsort_plan_free")


def _seg_radixsort_entry(suffix, want):
    def fn(plan, keycol: Column, valcol: Column | None,
           num_segments=None, d_begin_offsets=None, d_end_offsets=None):
        require(plan.ready, GDFStatus.GDF_INVALID_API_CALL,
                "segmented radixsort plan not set up")
        if want is not None:
            require(keycol.data.dtype == want,
                    GDFStatus.GDF_UNSUPPORTED_DTYPE,
                    f"gdf_segmented_radixsort_{suffix} wants {want}")
        offs = as_tensor(d_begin_offsets, keycol.device, torch.int32)
        return ops.segmented_radixsort(
            keycol, valcol, offs, descending=plan.descending,
            begin_bit=plan.begin_bit, end_bit=plan.end_bit)
    fn.__name__ = f"gdf_segmented_radixsort_{suffix}"
    fn.__doc__ = ("≅ gdf_segmented_radixsort_* (src/segmented_sorting.cu:"
                  "51-160, cub::DeviceSegmentedRadixSort)")
    return fn


for _sfx in ("i8", "i32", "i64", "f32", "f64"):
    _expose(_seg_radixsort_entry(_sfx, _SFX_DTYPE[_sfx]))
_expose(_seg_radixsort_entry("generic", None))


# ---------------------------------------------------------------------------
# Quantiles (src/quantiles.cu)
# ---------------------------------------------------------------------------

_expose(lambda col, q, method="linear", context=None:
        ops.quantile_exact(col, q, method), "gdf_quantile_exact")
# sic: the typo is part of the reference ABI (functions.h:782)
_expose(lambda col, q, context=None: ops.quantile_approx(col, q),
        "gdf_quantile_aprrox")


# ---------------------------------------------------------------------------
# I/O: CSV ingest, CSR conversion, Arrow IPC (io_functions.h, src/ipc.cu)
# ---------------------------------------------------------------------------

from ..io import csv as _csv_io  # noqa: E402
from ..io import csr as _csr_io  # noqa: E402
from ..io import ipc as _ipc_io  # noqa: E402

_expose(_csv_io.read_csv, "read_csv")
_expose(_csr_io.gdf_to_csr, "gdf_to_csr")
for _n in ("gdf_ipc_parser_open", "gdf_ipc_parser_open_recordbatches",
           "gdf_ipc_parser_close", "gdf_ipc_parser_failed",
           "gdf_ipc_parser_to_json", "gdf_ipc_parser_get_error",
           "gdf_ipc_parser_get_data", "gdf_ipc_parser_get_data_offset",
           "gdf_ipc_parser_get_schema_json",
           "gdf_ipc_parser_get_layout_json"):
    _expose(getattr(_ipc_io, _n), _n)


# ---------------------------------------------------------------------------
# RMM memory-manager API (include/memory.h, src/memory/memory.cpp)
# ---------------------------------------------------------------------------

from ..memory import manager as _rmm  # noqa: E402

for _n in ("rmmInitialize", "rmmFinalize", "rmmIsInitialized", "rmmAlloc",
           "rmmRealloc", "rmmFree", "rmmGetAllocationOffset", "rmmGetInfo",
           "rmmGetErrorString", "rmmLogSize", "rmmGetLog", "rmmWriteLog"):
    _expose(getattr(_rmm, _n), _n)
