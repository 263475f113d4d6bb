"""Sorting: key encodings, packed sort words, order_by and sort_table.

Counterpart of `libgdf_tpu/ops/sort.py` (≅ multi_col_order_by,
libgdf/src/sqls_rtti_comp.hpp:299-320, and gdf_order_by, sqls_ops.cu:
1373-1392). Each key column becomes an order-preserving integer; null and
dead-row flags and the encodings are packed into 64-bit sort words.

Torch's unsigned types have no `>>` and no `<`, so everything here is
int64 in **signed form**:

  - `radix_encode` maps a column of bit width w onto int64 E = U - 2^(w-1),
    where U is the JAX package's unsigned encoding. Signed order of E is
    unsigned order of U; descending is ~E, as ~U is in the JAX package.
  - a packed sort word holds the JAX package's u64 word W as W ^ 2^63, so
    that signed comparison of words is unsigned comparison of W.

Right shifts on int64 are arithmetic, so every field extraction masks.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..core.bits import f64_ieee_bits
from ..core.column import Column
from ..core.errors import GDFStatus, require
from ..core.table import Table
from ..utils.metrics import op_metrics, table_bytes
from .engine import multi_sort

SIGN = -(1 << 63)            # int64 with only the sign bit set
_LOW63 = (1 << 63) - 1


def radix_width(dtype: torch.dtype) -> int:
    """Bit width of a dtype's radix encoding."""
    return dtype.itemsize * 8


def radix_encode(data: torch.Tensor, ascending: bool = True) -> torch.Tensor:
    """Monotone map of a numeric column onto int64 (signed form of the JAX
    package's unsigned encoding): a < b iff enc(a) < enc(b). float64 bits
    are canonicalized first (core/bits.py); float32 bits are taken raw, as
    in the JAX package."""
    dt = data.dtype
    if dt == torch.float64:
        b = f64_ieee_bits(data)
        enc = torch.where(b < 0, b ^ _LOW63, b)
    elif dt == torch.float32:
        b = data.view(torch.int32).to(torch.int64)
        enc = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    elif dt in (torch.int8, torch.int16, torch.int32, torch.int64):
        enc = data.to(torch.int64)
    elif dt in (torch.uint8, torch.bool):
        enc = data.to(torch.int64) - 128
    else:
        require(False, GDFStatus.GDF_UNSUPPORTED_DTYPE, str(dt))
    return enc if ascending else ~enc


def radix_decode(enc: torch.Tensor, dtype: torch.dtype,
                 ascending: bool = True) -> torch.Tensor:
    """Inverse of radix_encode (values come back canonicalized)."""
    if not ascending:
        enc = ~enc
    if dtype == torch.bool:
        return enc != -128
    if dtype == torch.uint8:
        return (enc + 128).to(torch.uint8)
    if dtype == torch.float64:
        return torch.where(enc < 0, enc ^ _LOW63, enc).view(torch.float64)
    if dtype == torch.float32:
        b = torch.where(enc < 0, enc ^ 0x7FFFFFFF, enc)
        return b.to(torch.int32).view(torch.float32)
    return enc.to(dtype)


def radix_bits(enc: torch.Tensor, nbits: int) -> torch.Tensor:
    """The unsigned encoding U of an nbits-wide key as an int64 field value
    (for nbits = 64: its bit pattern)."""
    if nbits == 64:
        return enc ^ SIGN
    return enc + (1 << (nbits - 1))


def radix_from_bits(bits: torch.Tensor, nbits: int) -> torch.Tensor:
    """Inverse of radix_bits."""
    if nbits == 64:
        return bits ^ SIGN
    return bits - (1 << (nbits - 1))


def _shr(v: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits by 0 <= s < 64."""
    return v if s == 0 else (v >> s) & ((1 << (64 - s)) - 1)


def pack_bit_fields(fields, iota_bits: int = 0, n: int | None = None,
                    device=None):
    """Pack ordered bit fields into the minimum number of 64-bit sort words
    (signed form). `fields` is a list of (int64 value, nbits), each value
    holding an unsigned, order-normalized field in its low nbits (for
    nbits = 64, its bit pattern). Field 0 is most significant; fields may
    straddle words. With `iota_bits`, a row-index field lands in the low
    bits of the last word: it makes rows unique and carries the
    permutation (see libgdf_tpu/ops/sort.py::pack_bit_fields)."""
    total = 0
    placed = []
    for v, nbits in fields:
        if nbits == 0:
            continue
        placed.append((v.to(torch.int64), nbits, total))
        total += nbits
    if iota_bits:
        total += (64 - ((total + iota_bits) % 64)) % 64
        if device is None and placed:
            device = placed[0][0].device
        iota = torch.arange(n, dtype=torch.int64, device=device)
        placed.append((iota, iota_bits, total))
        total += iota_bits
    nwords = max(1, -(-total // 64))
    words = [None] * nwords

    def put(w, x):
        words[w] = x if words[w] is None else words[w] | x

    for v, nbits, off in placed:
        w, start = divmod(off, 64)
        avail = 64 - start
        if nbits <= avail:
            put(w, v << (avail - nbits))
        else:
            spill = nbits - avail
            put(w, _shr(v, spill))
            put(w + 1, (v & ((1 << spill) - 1)) << (64 - spill))
    zero = torch.zeros_like(placed[0][0])
    return [(zero if w is None else w) ^ SIGN for w in words]


def bit_field_offsets(nbits_list):
    """Global bit offsets of each field in the pack_bit_fields layout."""
    offs, total = [], 0
    for nb in nbits_list:
        offs.append(total)
        total += nb
    return offs, total


def unpack_bit_field(words, off: int, nbits: int) -> torch.Tensor:
    """The field at global bit offset `off` of signed-form sort words, as
    an int64 value (inverse of pack_bit_fields)."""
    w, start = divmod(off, 64)
    avail = 64 - start
    bits = words[w] ^ SIGN
    if nbits <= avail:
        v = _shr(bits, avail - nbits)
    else:
        spill = nbits - avail
        v = ((bits & ((1 << avail) - 1)) << spill) | _shr(
            words[w + 1] ^ SIGN, 64 - spill)
    return v if nbits == 64 else v & ((1 << nbits) - 1)


def _null_flag(col: Column, nulls_last: bool, live=None):
    """0/1/2 sort flag placing NULLs first/last and dead rows last; None
    when no flag is needed."""
    if col.valid is None and live is None:
        return None
    if col.valid is None:
        flag = torch.zeros(col.size, dtype=torch.int64, device=col.device)
    else:
        null = (~col.valid).to(torch.int64)
        flag = null if nulls_last else 1 - null
    if live is not None:
        flag = torch.where(live, flag, 2)
    return flag


def key_fields(table: Table, key_names: Sequence[str], ascending,
               nulls_last: bool = True) -> list:
    """Ordered (value, nbits) bit fields for a lexicographic table sort:
    per key a 1-bit null flag (2 bits on the first key of a capacity +
    count table, whose dead rows sort last), then the encoding."""
    if isinstance(ascending, bool):
        ascending = [ascending] * len(key_names)
    require(len(ascending) == len(key_names),
            GDFStatus.GDF_INVALID_API_CALL, "ascending list length mismatch")
    live = None if table.num_rows is None else table.live_mask()
    fields = []
    for name, asc in zip(key_names, ascending):
        col = table.column(name)
        flag = _null_flag(col, nulls_last, live)
        nbits_flag = 2 if live is not None else 1
        live = None
        if flag is not None:
            fields.append((flag, nbits_flag))
        w = radix_width(col.data.dtype)
        fields.append((radix_bits(radix_encode(col.data, asc), w), w))
    return fields


def order_by(table: Table, key_names: Sequence[str], ascending=True,
             nulls_last: bool = True) -> torch.Tensor:
    """The permutation (int32[capacity]) that sorts the table by the key
    columns; stable; dead rows of a capacity + count table go last.

    ≅ gdf_order_by (sqls_ops.cu:1373-1392), with per-key direction and
    null placement. The row index rides in the low bits of the last word,
    exactly as in the JAX package, so the order is the same."""
    n = table.capacity
    with op_metrics("LIBGDF_ORDERBY", rows_in=n,
                    bytes_est=2 * table_bytes(table)) as m:
        m["rows_out"] = n
        fields = key_fields(table, key_names, ascending, nulls_last)
        iota_bits = max(1, max(n - 1, 1).bit_length())
        words = pack_bit_fields(fields, iota_bits=iota_bits, n=n,
                                device=table.device)
        out = multi_sort(words, num_keys=len(words))
        return ((out[-1] ^ SIGN) & ((1 << iota_bits) - 1)).to(torch.int32)


def sort_table(table: Table, key_names: Sequence[str] | None = None,
               ascending=True, nulls_last: bool = True) -> Table:
    """Reorder the table into sorted order (≅ gdf_table::sort,
    gdf_table.cuh:1020-1050)."""
    keys = list(key_names) if key_names else list(table.names)
    perm = order_by(table, keys, ascending, nulls_last).to(torch.int64)
    cols = [Column(data=c.data[perm],
                   valid=None if c.valid is None else c.valid[perm],
                   info=c.info, name=c.name) for c in table.columns]
    return Table(columns=tuple(cols), names=table.names,
                 num_rows=table.num_rows)
