"""Elementwise unary/binary/comparison ops with null propagation.

Counterpart of `libgdf_tpu/ops/elementwise.py` (≅ libgdf/src/unaryops.cu
:96-497 unary math and the cast matrix, src/binaryops.cu :9-31, and
src/filterops.cu :17-95, 162-260). Each op is a whole-column torch
expression over every lane; the validity mask rides alongside, and a NULL
lane's payload is never observed.

The results are the JAX package's in every lane, also where torch's own
operator would answer otherwise:

  - integer floor-division by zero gives -1 where the dividend is 0 and -2
    elsewhere, and INT_MIN // -1 wraps to INT_MIN (XLA's integer division;
    torch raises on the CPU and leaves it to the hardware on the card);
  - float floor-division follows CPython's float_divmod, as jnp does, so a
    zero divisor gives NaN (torch gives +-inf);
  - `div` of two integer columns is float64 if either is int64, else
    float32 (torch divides int64 in float32);
  - a float -> integer cast saturates at the target's range and maps NaN
    to 0 (XLA's convert; torch's is undefined out of range);
  - a denormal float is zero (`core/bits.py::flush_denormals`) wherever
    it enters arithmetic or a widening, as XLA reads it: on the inputs of
    add / sub / mul / div / floor-division, the comparisons, float <->
    float casts (and their outputs) and sqrt / floor / ceil / log. Each
    input is flushed in its own dtype, before any promotion: a float32
    denormal widened to float64 is a normal number, and one scaled or
    accumulated becomes one too, so a later flush would not catch it
    (float32 1e-40 * 1e30 is 1e-10, not 0). Results are not flushed: a
    denormal result is read as zero by the next op it enters, and only a
    user who reads it directly sees it (float32 1.5e-38 - 1.4e-38 is
    1e-39 here, 0.0 in the JAX package);
  - a bitwise op on a float column raises TypeError, as jnp's do.
"""
from __future__ import annotations

import torch

from ..core.bitmask import mask_and
from ..core.bits import flush_denormals
from ..core.column import Column
from ..core.dtypes import DtypeInfo, GDFDtype, TimeUnit, dtype_from_numpy
from ..core.errors import GDFError, GDFStatus, require

# ---------------------------------------------------------------------------
# Unary math (unaryops.cu:96-335)
# ---------------------------------------------------------------------------

_UNARY_FNS = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "exp": torch.exp, "log": torch.log, "sqrt": torch.sqrt,
    "ceil": torch.ceil, "floor": torch.floor,
}
# where a denormal input changes the result past its last bits
_FLUSHED_UNARY = ("log", "sqrt", "ceil", "floor")


def unary_op(col: Column, op: str) -> Column:
    """Apply a named unary math fn; validity passes through.

    ≅ gdf_sin_f32 … gdf_floor_f64 (unaryops.cu:96-335; f32/f64 only)."""
    require(op in _UNARY_FNS, GDFStatus.GDF_INVALID_API_CALL,
            f"unknown unary op {op!r}")
    require(col.info.is_floating, GDFStatus.GDF_UNSUPPORTED_DTYPE,
            f"{op} requires FLOAT32/FLOAT64")
    data = flush_denormals(col.data) if op in _FLUSHED_UNARY else col.data
    return col.with_data(_UNARY_FNS[op](data))


def sin(c): return unary_op(c, "sin")
def cos(c): return unary_op(c, "cos")
def tan(c): return unary_op(c, "tan")
def asin(c): return unary_op(c, "asin")
def acos(c): return unary_op(c, "acos")
def atan(c): return unary_op(c, "atan")
def exp(c): return unary_op(c, "exp")
def log(c): return unary_op(c, "log")
def sqrt(c): return unary_op(c, "sqrt")
def ceil(c): return unary_op(c, "ceil")
def floor(c): return unary_op(c, "floor")


# ---------------------------------------------------------------------------
# Cast matrix (unaryops.cu:338-497)
# ---------------------------------------------------------------------------

def _units_per_day(info: DtypeInfo) -> int:
    """Sub-day units per day of a datetime dtype (unaryops.cu:385-462)."""
    d = info.gdf_dtype
    if d == GDFDtype.DATE32:
        return 1
    if d == GDFDtype.DATE64:
        return 86400000
    if d == GDFDtype.TIMESTAMP:
        return {
            TimeUnit.NONE: 86400000,  # default unit is ms (types.h:25)
            TimeUnit.s: 86400,
            TimeUnit.ms: 86400000,
            TimeUnit.us: 86400000000,
            TimeUnit.ns: 86400000000000,
        }[info.time_unit]
    raise GDFError(GDFStatus.GDF_UNSUPPORTED_DTYPE, f"not a datetime: {d}")


def convert(data: torch.Tensor, to: torch.dtype) -> torch.Tensor:
    """`data` as dtype `to`, with XLA's float -> integer rule: NaN becomes
    0 and a value past the target's range its nearest end. Every other
    conversion is torch's (integers wrap, floats round)."""
    if not data.is_floating_point() or to.is_floating_point:
        return data.to(to)
    info = torch.iinfo(to)
    # the ends as `data`'s dtype; iinfo.max rounds up to 2^k where it has
    # no exact float, and every float >= 2^k is past the range
    lo = torch.tensor(info.min, dtype=data.dtype, device=data.device)
    hi = torch.tensor(info.max, dtype=data.dtype, device=data.device)
    over, under = data >= hi, data <= lo
    inside = ~(over | under | torch.isnan(data))
    out = torch.where(inside, data, torch.zeros_like(data)).to(to)
    out = torch.where(over, info.max, out)
    return torch.where(under, info.min, out)


def cast(col: Column, to: GDFDtype,
         time_unit: TimeUnit = TimeUnit.NONE) -> Column:
    """Full 9x9 cast matrix incl. datetime unit scaling.

    ≅ gdf_cast_* (unaryops.cu:465-497). Datetime -> datetime scales by the
    unit ratio: an up-cast multiplies (:346-352), a down-cast floor-divides
    (:354-361). Everything else is a physical conversion (`convert`)."""
    if time_unit is None:
        time_unit = TimeUnit.NONE
    to_info = DtypeInfo(to, time_unit)
    from_info = col.info
    if from_info.is_datetime and to_info.is_datetime:
        f, t = _units_per_day(from_info), _units_per_day(to_info)
        wide = col.data.to(torch.int64)
        if t >= f:
            out = wide * (t // f)
        else:
            out = torch.div(wide, f // t, rounding_mode="floor")
        out = out.to(to_info.physical)
    elif col.data.is_floating_point() and to_info.physical.is_floating_point \
            and col.data.dtype != to_info.physical:
        out = flush_denormals(flush_denormals(col.data).to(to_info.physical))
    else:
        out = convert(col.data, to_info.physical)
    return Column(data=out, valid=col.valid, info=to_info, name=col.name)


# ---------------------------------------------------------------------------
# Binary ops (binaryops.cu)
# ---------------------------------------------------------------------------

def _promote(a: torch.Tensor, b: torch.Tensor):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _floordiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _promote(flush_denormals(a), flush_denormals(b))
    if a.is_floating_point():
        # CPython's float_divmod, as jnp.floor_divide
        mod = torch.fmod(a, b)
        div = (a - mod) / b
        adjust = (mod != 0) & (torch.sign(b) != torch.sign(mod))
        return torch.round(torch.where(adjust, div - 1, div))
    zero, minus1 = b == 0, b == -1
    safe = torch.where(zero | minus1, torch.ones_like(b), b)
    q = torch.div(a, safe, rounding_mode="floor")
    q = torch.where(minus1, -a, q)                   # INT_MIN wraps
    return torch.where(zero, -1 - (a != 0).to(a.dtype), q)


def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _promote(flush_denormals(a), flush_denormals(b))
    if not a.is_floating_point():
        wide = torch.float64 if a.dtype == torch.int64 else torch.float32
        a, b = a.to(wide), b.to(wide)
    return a / b


def _flushed(fn):
    """fn over its inputs, each flushed in its own dtype first."""
    return lambda a, b: fn(flush_denormals(a), flush_denormals(b))


def _bitwise(fn):
    def op(a, b):
        if a.is_floating_point() or b.is_floating_point():
            raise TypeError(f"{fn.__name__} is defined for integer and "
                            f"bool columns, not {a.dtype} and {b.dtype}")
        return fn(a, b)
    return op


_ARITH = {
    "add": _flushed(torch.add), "sub": _flushed(torch.sub),
    "mul": _flushed(torch.mul), "div": _div, "floordiv": _floordiv,
    "bitwise_and": _bitwise(torch.bitwise_and),
    "bitwise_or": _bitwise(torch.bitwise_or),
    "bitwise_xor": _bitwise(torch.bitwise_xor),
}
_CMP = {
    "gt": torch.gt, "ge": torch.ge, "lt": torch.lt, "le": torch.le,
    "eq": torch.eq, "ne": torch.ne,
}

_CMP_ENUM = {  # gdf_comparison_operator, types.h:188-195
    0: "eq", 1: "ne", 2: "lt", 3: "le", 4: "gt", 5: "ge",
    "eq": "eq", "ne": "ne", "lt": "lt", "le": "le", "gt": "gt", "ge": "ge",
}

_INT8 = DtypeInfo(GDFDtype.INT8)


def binary_op(a: Column, b: Column, op: str) -> Column:
    """Arithmetic/bitwise binary op, valid where both inputs are
    (binaryops.cu:22-24); comparison ops return INT8 0/1. The output keeps
    `a`'s logical dtype where the result has its physical dtype."""
    if op in _CMP:
        return compare(a, b, op)
    require(a.size == b.size, GDFStatus.GDF_COLUMN_SIZE_MISMATCH)
    if op in _ARITH:
        out = _ARITH[op](a.data, b.data)
        info = a.info if out.dtype == a.info.physical else \
            DtypeInfo(dtype_from_numpy(out.dtype))
        return Column(data=out, valid=mask_and(a.valid, b.valid), info=info,
                      name=a.name)
    raise GDFError(GDFStatus.GDF_INVALID_API_CALL, f"unknown binop {op!r}")


def add(a, b): return binary_op(a, b, "add")
def sub(a, b): return binary_op(a, b, "sub")
def mul(a, b): return binary_op(a, b, "mul")
def div(a, b): return binary_op(a, b, "div")
def floordiv(a, b): return binary_op(a, b, "floordiv")
def gt(a, b): return binary_op(a, b, "gt")
def ge(a, b): return binary_op(a, b, "ge")
def lt(a, b): return binary_op(a, b, "lt")
def le(a, b): return binary_op(a, b, "le")
def eq(a, b): return binary_op(a, b, "eq")
def ne(a, b): return binary_op(a, b, "ne")
def bitwise_and(a, b): return binary_op(a, b, "bitwise_and")
def bitwise_or(a, b): return binary_op(a, b, "bitwise_or")
def bitwise_xor(a, b): return binary_op(a, b, "bitwise_xor")


def compare_scalar(col: Column, value, op) -> Column:
    """column OP scalar -> INT8 stencil column (1 = pass).

    ≅ gpu_comparison_static_* (filterops.cu:17-95). An integer column
    compared with a float scalar compares in float64, as the JAX package's
    promotion does; otherwise the scalar takes the column's dtype."""
    op = _CMP_ENUM[op]
    data = col.data
    if isinstance(value, float) and not data.is_floating_point():
        data = data.to(torch.float64)
    if data.is_floating_point():
        data = flush_denormals(data)
        if not isinstance(value, torch.Tensor):
            # the scalar as the column's dtype, flushed on the host
            value = flush_denormals(torch.tensor(value,
                                                 dtype=data.dtype)).item()
    out = _CMP[op](data, value).to(torch.int8)
    return Column(data=out, valid=col.valid, info=_INT8, name=col.name)


def compare(a: Column, b: Column, op) -> Column:
    """column OP column -> INT8 stencil; valid where both inputs are
    (≅ gpu_comparison, filterops.cu:162-260)."""
    op = _CMP_ENUM[op]
    require(a.size == b.size, GDFStatus.GDF_COLUMN_SIZE_MISMATCH)
    out = _CMP[op](flush_denormals(a.data),
                   flush_denormals(b.data)).to(torch.int8)
    return Column(data=out, valid=mask_and(a.valid, b.valid), info=_INT8,
                  name=a.name)
