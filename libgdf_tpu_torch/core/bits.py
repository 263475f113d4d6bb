"""Raw-bit views of columns, float64 canonicalized.

Counterpart of `f64_ieee_bits`, `to_unsigned_bits` and `u64_words` in
`libgdf_tpu/core/bits.py`. The JAX package derives float64 bits
arithmetically and, in doing so, canonicalizes: -0.0 and denormals become
+0.0's bits and every NaN the canonical quiet NaN. Sort, group, join and
hash results follow those bits, so the port applies the same fix-ups to
`tensor.view(torch.int64)`. Narrower floats keep their raw bits, as there.

Torch's unsigned types have no `>>`, so an unsigned bit pattern is held in
an int64: a w-bit pattern (w < 64) as its value in [0, 2^w), a 64-bit one
as the int64 with the same bits.
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


def flush_float_keys(data: torch.Tensor) -> torch.Tensor:
    """A float32 or float64 key column as the JAX package compares it:
    -0.0 and every denormal become +0.0. Its `where(data == 0, 0, data)`
    fix-up for join and groupby keys runs under XLA, which flushes
    denormals in comparisons; torch does not, on the CPU or the card."""
    zero = data.abs() < torch.finfo(data.dtype).tiny
    return torch.where(zero, torch.zeros_like(data), data)


def flush_denormals(data: torch.Tensor) -> torch.Tensor:
    """A denormal is zero, as on the TPU: every |x| < finfo(dtype).tiny of
    a float tensor becomes a zero of its own sign; other dtypes pass
    through. XLA flushes the denormal inputs of comparisons, casts,
    min / max, floor-division and sqrt / floor / ceil / log, on the TPU
    and on the CPU alike; torch does not, on the CPU or the card."""
    if not data.is_floating_point():
        return data
    return torch.where(data.abs() < torch.finfo(data.dtype).tiny, data * 0,
                       data)


_MASK = {1: 0xFF, 2: 0xFFFF, 4: 0xFFFFFFFF}
_SAME_WIDTH_INT = {1: torch.int8, 2: torch.int16, 4: torch.int32}


def to_unsigned_bits(data: torch.Tensor) -> torch.Tensor:
    """Bit pattern of a fixed-width column as int64 (module docstring):
    float64 canonicalized, bool as uint8, everything else raw."""
    dt = data.dtype
    if dt == torch.float64:
        return f64_ieee_bits(data)
    if dt == torch.bool:
        return data.to(torch.int64)
    width = data.element_size()
    if width == 8:
        return data.view(torch.int64)
    bits = data.view(_SAME_WIDTH_INT[width]).to(torch.int64)
    return bits & _MASK[width]


def u64_words(u: torch.Tensor):
    """(lo32, hi32) of a 64-bit pattern, each an int64 in [0, 2^32)."""
    return u & 0xFFFFFFFF, (u >> 32) & 0xFFFFFFFF
