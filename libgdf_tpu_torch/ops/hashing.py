"""Row hashing and hash partitioning.

Counterpart of `libgdf_tpu/ops/hashing.py` (≅ MurmurHash3_32 with
boost-style hash_combine and IdentityHash, hash_functions.cuh:30-161;
gdf_table::hash_row, gdf_table.cuh:704-854; gdf_hash and
gdf_hash_partition, src/hashing.cu:54-654). Hashes are bit-exact with the
JAX package, so a row lands in the same partition in both.

Torch's unsigned types have no `>>`, so the 32-bit arithmetic runs in
int64 and every product, rotate and shift is masked back to 32 bits: an
int64 product keeps its low 32 bits exact even when it wraps. A 32-bit
hash is returned as an int64 in [0, 2^32); FNV-1a's 64-bit hash as the
int64 with the same bits.
"""
from __future__ import annotations

import torch

from ..core.bits import to_unsigned_bits, u64_words
from ..core.column import Column
from ..core.dtypes import DtypeInfo, GDFDtype
from ..core.errors import GDFStatus, require
from ..core.table import Table
from ..utils.tracing import host_sync
from .engine import multi_sort

M32 = 0xFFFFFFFF
_C1 = 0xcc9e2d51
_C2 = 0x1b873593
_N = 0xe6546b64
_GOLDEN = 0x9e3779b9
_FNV_OFFSET = 14695981039346656037 - (1 << 64)   # as a signed int64
_FNV_PRIME = 1099511628211


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def _fmix32(h):
    """hash_functions.cuh:48-56."""
    h = h ^ (h >> 16)
    h = (h * 0x85ebca6b) & M32
    h = h ^ (h >> 13)
    h = (h * 0xc2b2ae35) & M32
    return h ^ (h >> 16)


def _body_block(h1, k1):
    """One 4-byte body block (hash_functions.cuh:92-101)."""
    k1 = _rotl32((k1 * _C1) & M32, 15)
    k1 = (k1 * _C2) & M32
    h1 = _rotl32(h1 ^ k1, 13)
    return (h1 * 5 + _N) & M32


def _tail_block(h1, k1):
    """Tail mix for widths 1-3 (hash_functions.cuh:104-112)."""
    k1 = _rotl32((k1 * _C1) & M32, 15)
    return h1 ^ ((k1 * _C2) & M32)


def murmur3_32(data: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """MurmurHash3_32 of each value's little-endian bytes, bit-exact with
    hash_functions.cuh:80-118; 8-byte values hash their low word, then
    their high word. Returns int64 in [0, 2^32)."""
    width = data.element_size()
    require(width in (1, 2, 4, 8), GDFStatus.GDF_UNSUPPORTED_DTYPE,
            f"hash width {width}")
    h1 = torch.full(data.shape, seed & M32, dtype=torch.int64,
                    device=data.device)
    u = to_unsigned_bits(data)
    if width == 8:
        lo, hi = u64_words(u)
        h1 = _body_block(_body_block(h1, lo), hi)
    elif width == 4:
        h1 = _body_block(h1, u)
    else:
        h1 = _tail_block(h1, u)
    return _fmix32(h1 ^ width)


def fnv1a_64_columns(columns) -> torch.Tensor:
    """Row-wise FNV-1a (64-bit) over the little-endian bytes of every
    column value, bit-exact with hash_fnv_array_op (libgdf/src/hashops.cu:
    25-120), including its xor of each byte as a sign-extended char.
    Returns the uint64 hash's bits as int64."""
    require(len(columns) > 0, GDFStatus.GDF_DATASET_EMPTY)
    h = None
    for c in columns:
        data = c.data if isinstance(c, Column) else c
        width = data.element_size()
        require(width in (1, 2, 4, 8), GDFStatus.GDF_UNSUPPORTED_DTYPE,
                f"fnv width {width}")
        u = to_unsigned_bits(data)
        if h is None:
            h = torch.full(data.shape, _FNV_OFFSET, dtype=torch.int64,
                           device=data.device)
        for j in range(width):
            byte = (u >> (8 * j)) & 0xFF
            sx = torch.where(byte >= 128, byte - 256, byte)
            h = (h ^ sx) * _FNV_PRIME
    return h


def identity_hash_32(data: torch.Tensor) -> torch.Tensor:
    """≅ IdentityHash (hash_functions.cuh:129-161): static_cast to u32.
    Integers wrap modulo 2^32; floats take XLA's saturating convert: NaN
    and x <= -1 give 0, x >= 2^32 gives 2^32 - 1, the rest truncate toward
    zero. Floats are clamped in float64 (exact for every float dtype)
    before the integer conversion, which is undefined for inf and NaN."""
    if not data.is_floating_point():
        return data.to(torch.int64) & M32
    x = data.to(torch.float64)
    x = torch.where(torch.isnan(x), 0.0, x.clamp(0.0, float(M32)))
    return x.to(torch.int64)


def hash_combine(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Boost hash_combine (hash_functions.cuh:71-78), 32-bit."""
    return lhs ^ ((rhs + _GOLDEN + ((lhs << 6) & M32) + (lhs >> 2)) & M32)


def hash_columns(columns, hash_fn: str = "murmur3") -> torch.Tensor:
    """Row hash over a list of Columns (or tensors): the first column's
    hash, then hash_combine with each next one (≅ gdf_table::hash_row,
    gdf_table.cuh:704-854). int64 in [0, 2^32)."""
    require(len(columns) > 0, GDFStatus.GDF_DATASET_EMPTY)
    require(hash_fn in ("murmur3", "identity"),
            GDFStatus.GDF_INVALID_HASH_FUNCTION, hash_fn)
    fn = murmur3_32 if hash_fn == "murmur3" else identity_hash_32
    out = None
    for c in columns:
        h = fn(c.data if isinstance(c, Column) else c)
        out = h if out is None else hash_combine(out, h)
    return out


def _as_int32_bits(h: torch.Tensor) -> torch.Tensor:
    """[0, 2^32) values -> the int32 with the same bits."""
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


def hash_table_rows(table: Table, num_columns_to_hash: int = 0,
                    hash_fn: str = "murmur3") -> Column:
    """≅ gdf_hash (src/hashing.cu:83-150): per-row hash column, the u32
    bits in an INT32 column like the reference's GDF_INT32 output."""
    k = num_columns_to_hash or table.num_columns
    h = hash_columns(table.columns[:k], hash_fn)
    return Column(data=_as_int32_bits(h), valid=None,
                  info=DtypeInfo(GDFDtype.INT32), name="hash")


def partition_ids(table: Table, key_names, num_partitions: int,
                  hash_fn: str = "murmur3") -> torch.Tensor:
    """Per-row partition number, modulo partitioner (hashing.cu:192-206:
    partition = hash % num_partitions), int32."""
    h = hash_columns([table.column(n) for n in key_names], hash_fn)
    return (h % num_partitions).to(torch.int32)


def hash_partition(table: Table, key_names, num_partitions: int,
                   hash_fn: str = "murmur3"):
    """Rearrange `table` so partition p's rows are contiguous, in their
    original order; return (partitioned Table, offsets int32[P]) with
    offsets[p] the start of partition p (≅ gdf_hash_partition,
    hashing.cu:559-654). Dead rows of a capacity + count table go last."""
    part = partition_ids(table, key_names, num_partitions, hash_fn)
    if table.num_rows is not None:
        part = torch.where(table.live_mask(), part, num_partitions)
    sorted_part, out = partition_apply(table, part)
    offsets = torch.searchsorted(
        sorted_part, torch.arange(num_partitions, dtype=torch.int32,
                                  device=part.device), side="left")
    return out, offsets.to(torch.int32)


def partition_apply(table: Table, part: torch.Tensor):
    """Stable-sort the table by a partition-id column. Returns (sorted
    part ids, partitioned Table)."""
    operands, layout = [part], []
    for c in table.columns:
        operands.append(c.data)
        if c.valid is not None:
            operands.append(c.valid)
        layout.append(c.valid is not None)
    res = multi_sort(operands, num_keys=1)
    cols, i = [], 1
    for c, has_valid in zip(table.columns, layout):
        cols.append(Column(data=res[i], valid=res[i + 1] if has_valid
                           else None, info=c.info, name=c.name))
        i += 2 if has_valid else 1
    out = Table(columns=tuple(cols), names=table.names)
    return res[0], out.with_num_rows(table.num_rows)


def partition_sizes(part_ids: torch.Tensor, num_partitions: int,
                    live_mask=None) -> torch.Tensor:
    """Histogram of partition ids over the live rows (≅ the global
    histogram of compute_row_partition_numbers, hashing.cu:259-320),
    int32[num_partitions]. Ids outside [0, num_partitions) count nowhere."""
    ok = (part_ids >= 0) & (part_ids < num_partitions)
    if live_mask is not None:
        ok = ok & live_mask
    ids = torch.where(ok, part_ids.to(torch.int64), num_partitions)
    with host_sync("hash.partition_sizes"):     # bincount reads ids' max
        counts = torch.bincount(ids, minlength=num_partitions + 1)
    return counts[:num_partitions].to(torch.int32)
