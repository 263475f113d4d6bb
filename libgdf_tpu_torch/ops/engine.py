"""Execution-engine primitives shared by the relational operators.

Counterpart of `libgdf_tpu/ops/engine.py`: one sort primitive and the 1-D
scans. The JAX package's cost model ("never gather") is the TPU's; on an
H100 a gather after an argsort runs at memory speed, so `multi_sort`
sorts keys and gathers payloads.

Scans dispatch on the tensor's device inside the kernel wrappers
(ops/kernels): the Hopper kernels for CUDA tensors, their plain PyTorch
versions for CPU tensors.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .kernels import scan, seg_scan


def multi_sort(operands: Sequence[torch.Tensor], num_keys: int):
    """Stable lexicographic sort by the first `num_keys` operands; every
    operand is permuted consistently.

    Stable torch.sort passes run from the least significant key to the
    most significant one, then the permutation gathers each operand
    (≅ jax.lax.sort with num_keys, is_stable=True)."""
    perm = None
    for key in reversed(operands[:num_keys]):
        k = key if perm is None else key[perm]
        if k.dtype == torch.bool:
            k = k.to(torch.uint8)
        _, idx = torch.sort(k, stable=True)
        perm = idx if perm is None else perm[idx]
    return [op[perm] for op in operands]


def cumsum(x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Inclusive prefix sum in `dtype` (default: x's dtype)."""
    if dtype is not None:
        x = x.to(dtype)
    return scan("sum", x)


def cummax(x: torch.Tensor) -> torch.Tensor:
    return scan("max", x)


def cummin(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    return scan("min", x, reverse=reverse)


def seg_scan_sum(vals: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented sum; `starts` marks segment heads. The value at
    each segment's last row is the segment total.

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
