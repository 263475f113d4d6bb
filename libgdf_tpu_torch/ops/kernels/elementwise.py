"""H8 `elementwise`: add / sub / mul of two float columns, and a column
compared with a scalar, each one pass with the denormal flush in its load.

Wrapper around `csrc/elementwise.cu` beside the plain PyTorch versions,
which are the torch expressions the operators ran before H8: each float
input through `core/bits.py::flush_denormals` (three passes), then the op,
and a compare's bool result copied to int8. On CPU tensors each wrapper
runs its plain version; on CUDA tensors it launches the kernel or raises.
One launch a call; none for 0 rows. The results are bit-identical to the
plain versions' (NaN as NaN, the sign of a zero kept).

`elementwise_binary(op, a, b)`: `a` and `b` float32 / float64, 1-D, of
one length, each contiguous or one element of stride 0 (a literal
expanded to the column's length; not both); the result has
`torch.promote_types`' dtype. `elementwise_compare(x, op, value)`: `x` a
contiguous 1-D int8-int64, float32 or float64 tensor, `value` a Python
scalar that `takes_scalar` accepts; the result is the int8 stencil.
`ops/elementwise.py` decides which calls come here.
"""
from __future__ import annotations

import torch

from ...core.bits import flush_denormals
from . import _lib

# the op codes of csrc/elementwise.cu
ARITH_OPS = {"add": 0, "sub": 1, "mul": 2}
CMP_OPS = {"eq": 0, "ne": 1, "lt": 2, "le": 3, "gt": 4, "ge": 5}
FLOATS = (torch.float32, torch.float64)
COMPARED = (torch.int8, torch.int16, torch.int32, torch.int64) + FLOATS
# the shapes of an arithmetic operand pair (csrc/elementwise.cu)
COLUMNS, SCALAR_A, SCALAR_B = 0, 1, 2
_TORCH_ARITH = {"add": torch.add, "sub": torch.sub, "mul": torch.mul}
_TORCH_CMP = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt,
              "le": torch.le, "gt": torch.gt, "ge": torch.ge}
_EXACT = 2 ** 53          # the ints a float64 holds exactly
_INT64 = 2 ** 63


def broadcast(t: torch.Tensor) -> bool:
    """Whether `t` is one element expanded to more (1-D, stride 0)."""
    return t.dim() == 1 and t.shape[0] > 1 and t.stride(0) == 0


def reads(t: torch.Tensor) -> bool:
    """Whether H8 reads `t` as an operand: 1-D, contiguous or
    `broadcast`."""
    return t.dim() == 1 and (t.is_contiguous() or t.stride(0) == 0)


def takes_scalar(dtype: torch.dtype, value) -> bool:
    """Whether H8 compares a column of `dtype` with `value` as the plain
    version does: a Python float, or a Python int that the kernel gets
    exactly (within int64; within +-2^53 against a float column, which it
    reaches through a float64)."""
    if isinstance(value, float):
        return dtype in COMPARED
    if isinstance(value, int):
        if dtype in FLOATS:
            return -_EXACT <= value <= _EXACT
        return dtype in COMPARED and -_INT64 <= value < _INT64
    return False


def elementwise_binary_plain(op: str, a: torch.Tensor,
                             b: torch.Tensor) -> torch.Tensor:
    """Plain version: each input flushed in its own dtype, then torch's
    op in the promoted dtype (any dtypes: an integer input passes)."""
    return _TORCH_ARITH[op](flush_denormals(a), flush_denormals(b))


def elementwise_binary(op: str, a: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """a OP b for op add / sub / mul, each input flushed in its own
    dtype first; the result unflushed, of the promoted dtype."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return elementwise_binary_plain(op, a, b)
    code = ARITH_OPS[op]
    if a.dtype not in FLOATS or b.dtype not in FLOATS:
        raise TypeError(f"elementwise_binary: float operands, not {a.dtype} "
                        f"and {b.dtype}")
    dev = a.device
    if dev.type != "cuda" or b.device != dev or a.shape != b.shape or \
            not reads(a) or not reads(b) or broadcast(a) and broadcast(b):
        raise ValueError("elementwise_binary: two 1-D tensors of one length "
                         "on one CUDA device, each contiguous or one "
                         "element broadcast, not both")
    shape = SCALAR_A if broadcast(a) else SCALAR_B if broadcast(b) \
        else COLUMNS
    dt = torch.promote_types(a.dtype, b.dtype)
    n = a.shape[0]
    out = torch.empty(n, dtype=dt, device=dev)
    if n:
        _lib.check(_lib.lib().gdf_elementwise_binary(
            code, _lib.DTYPE_CODES[a.dtype], _lib.DTYPE_CODES[b.dtype], shape,
            a.data_ptr(), b.data_ptr(), out.data_ptr(), n, dev.index,
            _lib.stream_ptr(dev)), "elementwise_binary")
        _lib.count_launch(elementwise_binary, dt)
    return out


def elementwise_compare_plain(x: torch.Tensor, op: str,
                              value) -> torch.Tensor:
    """Plain version: an integer column against a float is compared in
    float64; a float column is flushed and compared with the scalar as
    its dtype, flushed on the host (a tensor scalar as it is); the bool
    result as int8."""
    if isinstance(value, float) and not x.is_floating_point():
        x = x.to(torch.float64)
    if x.is_floating_point():
        x = flush_denormals(x)
        if not isinstance(value, torch.Tensor):
            value = flush_denormals(torch.tensor(value, dtype=x.dtype)).item()
    return _TORCH_CMP[op](x, value).to(torch.int8)


def elementwise_compare(x: torch.Tensor, op: str, value) -> torch.Tensor:
    """x OP value as the int8 stencil (1 = the row passes), for op eq /
    ne / lt / le / gt / ge; as the plain version reads both."""
    if x.device.type == "cpu":
        return elementwise_compare_plain(x, op, value)
    code = CMP_OPS[op]
    if not takes_scalar(x.dtype, value):
        raise TypeError(f"elementwise_compare: a {x.dtype} column against "
                        f"{value!r}")
    if x.device.type != "cuda" or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("elementwise_compare: a contiguous 1-D CUDA tensor")
    dev = x.device
    n = x.shape[0]
    out = torch.empty(n, dtype=torch.int8, device=dev)
    if n:
        in_float64 = isinstance(value, float) and not x.is_floating_point()
        exact_int = not (in_float64 or x.is_floating_point())
        _lib.check(_lib.lib().gdf_elementwise_compare(
            code, _lib.DTYPE_CODES[x.dtype], x.data_ptr(), in_float64,
            int(value) if exact_int else 0,
            0.0 if exact_int else float(value), out.data_ptr(), n,
            dev.index, _lib.stream_ptr(dev)), "elementwise_compare")
        _lib.count_launch(elementwise_compare, x.dtype)
    return out


elementwise_binary.launches = 0
elementwise_binary.launches_by_dtype = {}
elementwise_compare.launches = 0
elementwise_compare.launches_by_dtype = {}
