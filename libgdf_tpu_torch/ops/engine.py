"""Execution-engine primitives shared by the relational operators.

Counterpart of `libgdf_tpu/ops/engine.py`: one sort primitive and the 1-D
scans. The JAX package's cost model ("never gather") is the TPU's; on an
H100 a gather after an argsort runs at memory speed, so `multi_sort`
sorts keys and gathers payloads.

Scans dispatch on the tensor's device inside the kernel wrappers
(ops/kernels): the Hopper kernels for CUDA tensors, their plain PyTorch
versions for CPU tensors. Float sums read a denormal input as zero, as
XLA's do: H2 and H3 flush each element as they load it.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..core.bits import flush_denormals
from .kernels import scan, seg_scan


def multi_sort(operands: Sequence[torch.Tensor], num_keys: int,
               stable: bool = True):
    """Stable lexicographic sort by the first `num_keys` operands; every
    operand is permuted consistently.

    Stable torch.sort passes run from the least significant key to the
    most significant one, then the permutation gathers each operand
    (≅ jax.lax.sort with num_keys, is_stable=True). The sort is always
    stable; `stable` is accepted for the JAX package's signature."""
    perm = None
    for key in reversed(operands[:num_keys]):
        k = key if perm is None else key[perm]
        if k.dtype == torch.bool:
            k = k.to(torch.uint8)
        _, idx = torch.sort(k, stable=True)
        perm = idx if perm is None else perm[idx]
    return [op[perm] for op in operands]


def argsort_keys(keys: Sequence[torch.Tensor],
                 payloads: Sequence[torch.Tensor] = ()):
    """multi_sort of keys + iota + payloads; returns (sorted_keys, perm,
    sorted_payloads)."""
    keys = tuple(keys)
    iota = torch.arange(keys[0].shape[0], dtype=torch.int32,
                        device=keys[0].device)
    out = multi_sort(keys + (iota,) + tuple(payloads), num_keys=len(keys))
    return out[:len(keys)], out[len(keys)], out[len(keys) + 1:]


# Sum dtypes H2 has no instance for -> the instance they run at; the sum
# is cast back, which keeps the wrap of int8 / int16 (as the JAX package's
# routing does, libgdf_tpu/ops/engine.py:170-187).
_SUM_VIA = {torch.float16: torch.float32, torch.int8: torch.int32,
            torch.int16: torch.int32}


def cumsum(x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Inclusive prefix sum in `dtype` (default: x's dtype). int32, int64,
    float32 and float64 run at their own H2 instance (int64 and float64
    replace the TPU's K4a and K5a); float16 runs at float32 and int8 and
    int16 at int32, cast back. A denormal float input is zero, also one
    widened first (flushed in its own dtype before the widening)."""
    if dtype is not None and dtype != x.dtype:
        x = flush_denormals(x).to(dtype)
    via = _SUM_VIA.get(x.dtype)
    if via is None:
        return scan("sum", x)
    return scan("sum", flush_denormals(x).to(via)).to(x.dtype)


def cummax(x: torch.Tensor) -> torch.Tensor:
    return scan("max", x)


def cummin(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    return scan("min", x, reverse=reverse)


def seg_scan_sum(vals: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented sum; `starts` marks segment heads. The value at
    each segment's last row is the segment total.

    A denormal float value is zero (folded into H3's load).

    ≅ thrust::reduce_by_key's sum path (sqls_rtti_comp.hpp:496-505)."""
    return seg_scan("sum", starts, vals)


def seg_scan_min(vals: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    return _seg_select("min", vals, starts)


def seg_scan_max(vals: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    return _seg_select("max", vals, starts)


def _seg_select(kind: str, vals, starts):
    """Segmented min/max. float64 runs over its order-preserving int64
    encoding, so NaN is greatest (the total order of the sorts), as the
    TPU kernel does (libgdf_tpu/ops/engine.py:228-240)."""
    if vals.dtype == torch.float64:
        from .sort import radix_decode, radix_encode
        enc = radix_encode(vals, ascending=True)
        return radix_decode(seg_scan(kind, starts, enc), vals.dtype)
    return seg_scan(kind, starts, vals)


def last_valid_scan(valid: torch.Tensor, vals: torch.Tensor,
                    with_flag: bool = False):
    """For each position i, the value at the latest j <= i with valid[j]
    (carry-forward fill); positions before the first valid keep vals[i].
    Returns (filled, seen); `seen` (whether any valid j <= i exists) is
    computed only when with_flag=True, otherwise None."""
    out = seg_scan("carry", valid, vals)
    seen = cummax(valid.to(torch.int32)) > 0 if with_flag else None
    return out, seen
