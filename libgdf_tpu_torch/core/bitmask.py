"""Validity masks: unpacked bool tensors inside, packed bits at the boundary.

Counterpart of `libgdf_tpu/core/bitmask.py`. The reference stores validity
as an LSB-first packed bitmask (libgdf/include/gdf/utils.h:10-23); the
engine keeps one bool per row, and packs only for interchange.
"""
from __future__ import annotations

import torch

from ..utils.tracing import host_sync

GDF_VALID_BITSIZE = 8  # include/gdf/gdf.h:10


def num_bitmask_bytes(nrows: int) -> int:
    """≅ gdf_get_num_chars_bitmask (include/gdf/utils.h:18-23)."""
    return (nrows + GDF_VALID_BITSIZE - 1) // GDF_VALID_BITSIZE


def _bit_pos(device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device)


def pack_bool_mask(valid: torch.Tensor) -> torch.Tensor:
    """bool[n] -> uint8[ceil(n/8)] LSB-first packed bitmask (padding bits 0)."""
    n = valid.shape[0]
    nbytes = num_bitmask_bytes(n)
    padded = torch.zeros(nbytes * 8, dtype=torch.uint8, device=valid.device)
    padded[:n] = valid.to(torch.uint8)
    bits = padded.reshape(nbytes, 8) << _bit_pos(valid.device)
    return bits.sum(dim=1, dtype=torch.uint8)


def unpack_bitmask(mask: torch.Tensor, nrows: int) -> torch.Tensor:
    """uint8[ceil(n/8)] LSB-first -> bool[n] (≅ gdf_is_valid, utils.h:10-16)."""
    bits = (mask[:, None] >> _bit_pos(mask.device)) & 1
    return bits.reshape(-1)[:nrows].to(torch.bool)


def count_valid(valid: torch.Tensor | None, nrows: int,
                device=None) -> torch.Tensor:
    """Number of valid (non-null) rows, a 0-d int32 tensor.

    ≅ gdf_count_nonzero_mask (src/validops.cu:84-196). With no mask the
    count is `nrows`, on `device` (default: the CPU, it is a host number)."""
    if valid is None:
        with host_sync("bitmask.count"):    # a blocking copy
            return torch.tensor(nrows, dtype=torch.int32, device=device)
    return valid.sum(dtype=torch.int32)


def mask_and(a: torch.Tensor | None, b: torch.Tensor | None):
    """AND two optional bool masks (None = all-valid).

    ≅ apply_bitmask_to_bitmask (src/bitmaskops.cu:78-102)."""
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def mask_or(a: torch.Tensor | None, b: torch.Tensor | None):
    """OR two optional bool masks (None = all-False)."""
    if a is None:
        return b
    if b is None:
        return a
    return a | b


def mask_concat(masks, lengths, device=None) -> torch.Tensor:
    """Concatenate unpacked masks (≅ gdf_mask_concat, src/validops.cu:
    203-258); None stands for an all-valid mask of its length. The result
    lies with the first mask given, or on `device` if every mask is None
    (default: the card, as for host data)."""
    if device is None:
        device = next((m.device for m in masks if m is not None), None)
    device = _host_data_device(device)
    parts = [torch.ones(n, dtype=torch.bool, device=device) if m is None
             else m[:n] for m, n in zip(masks, lengths)]
    return torch.cat(parts)


def all_bitmask_on(nrows: int, device=None) -> torch.Tensor:
    """≅ all_bitmask_on (src/bitmaskops.cu:56-77): an all-valid mask, on the
    card unless `device` says otherwise."""
    return torch.ones(nrows, dtype=torch.bool,
                      device=_host_data_device(device))


def _host_data_device(device=None) -> torch.device:
    from .column import host_data_device  # column.py imports this module
    return host_data_device(device)
