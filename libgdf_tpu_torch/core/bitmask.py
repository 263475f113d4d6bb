"""Validity masks: unpacked bool tensors inside, packed bits at the boundary.

Counterpart of `libgdf_tpu/core/bitmask.py`. The reference stores validity
as an LSB-first packed bitmask (libgdf/include/gdf/utils.h:10-23); the
engine keeps one bool per row, and packs only for interchange.
"""
from __future__ import annotations

import torch

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
