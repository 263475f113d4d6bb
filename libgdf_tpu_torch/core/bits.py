"""Raw-bit views of float64 columns, canonicalized.

Counterpart of `f64_ieee_bits` in `libgdf_tpu/core/bits.py`. The JAX
package derives the bits arithmetically and, in doing so, canonicalizes:
-0.0 and denormals become +0.0's bits and every NaN the canonical quiet
NaN. Sort, group and join order follow those bits, so the port applies the
same fix-ups to `tensor.view(torch.int64)`.
"""
from __future__ import annotations

import torch

CANONICAL_NAN_BITS = 0x7FF8000000000000
_MIN_NORMAL = 2.0 ** -1022


def f64_ieee_bits(x: torch.Tensor) -> torch.Tensor:
    """IEEE-754 bit pattern of a float64 tensor as int64, canonicalized:
    -0.0 and denormals -> 0, NaN -> 0x7FF8000000000000."""
    if x.dtype != torch.float64:
        raise TypeError(f"f64_ieee_bits wants float64, got {x.dtype}")
    bits = x.view(torch.int64)
    zero = x.abs() < _MIN_NORMAL
    bits = torch.where(zero, torch.zeros_like(bits), bits)
    return torch.where(torch.isnan(x),
                       torch.full_like(bits, CANONICAL_NAN_BITS), bits)
