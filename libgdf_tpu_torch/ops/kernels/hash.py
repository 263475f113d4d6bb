"""H6 `hash_build` and `hash_probe`: an inner equi-join on one key column
whose build side holds each key at most once, through a hash table.

Wrappers around `csrc/hash_join.cu` (which says what bounds them and what
their design does about it; they replace no TPU kernel), each beside its
plain PyTorch version. On CPU tensors a wrapper runs the plain version; on
CUDA tensors it launches the kernel or raises.

  hash_build(keys, valid, num_rows)
      a `HashTable` of the build side's live rows (below `num_rows`) whose
      key is valid and no NaN; its `result`, int64 [2], holds 0 and the
      duplicate flag (1 where a key came twice; the table then holds one
      of the equal keys' rows). Three memsets (the table, the result) and
      one launch; for an empty build side none, and its table matches
      nothing.
  hash_probe(table, keys, valid, num_rows, capacity)
      (probe rows int32[capacity], build rows int32[capacity], result):
      every live, matchable probe row whose key the table holds, as a pair,
      in no fixed order, the first `capacity` pairs written; `result[0]`
      counts every match. One memset of the count and one launch; none
      where either side is empty (a fill zeroes the count).

A key matches as the sort path compares it (ops/join.py): integers by
value, floats by their bits with -0.0 and denormals read as +0.0; a NaN
never matches. The plain versions build a `SortedTable` (the build keys
sorted) and search it; their pairs come in probe-row order, the padding
is -1.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...core.bits import flush_float_keys
from ...core.table import live_rows
from . import _lib

KEY_DTYPES = _lib.DTYPE_CODES


@dataclass(frozen=True)
class HashTable:
    """A table `hash_build` built on the card: the key dtype, its slots
    (0 for an empty build side), whether a probe stages it in shared
    memory, its device buffer and the result."""
    dtype: torch.dtype
    slots: int
    staged: bool
    data: torch.Tensor | None
    result: torch.Tensor


@dataclass(frozen=True)
class SortedTable:
    """The plain version's table: the key dtype, the matchable keys sorted
    (stable), their rows and the result."""
    dtype: torch.dtype
    keys: torch.Tensor
    rows: torch.Tensor
    result: torch.Tensor


def _check(what, keys, valid, num_rows):
    if keys.dim() != 1 or keys.dtype not in KEY_DTYPES:
        raise TypeError(f"{what}: keys must be a 1-D column of "
                        f"{sorted(str(d) for d in KEY_DTYPES)}")
    if keys.shape[0] >= 2 ** 31:
        raise ValueError(f"{what}: at most 2^31 - 1 rows")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != keys.shape):
        raise ValueError(f"{what}: valid must be a bool mask of the keys")
    if num_rows is not None and num_rows.dtype != torch.int32:
        raise ValueError(f"{what}: num_rows must be an int32 tensor")


def _on_card(what, keys, valid, num_rows, *more):
    ts = [keys, *more] + [t for t in (valid, num_rows) if t is not None]
    if all(t.device.type == "cpu" for t in ts):
        return None
    return _lib.require_cuda(what, *ts)


# -- plain versions -------------------------------------------------------------

def _canonical_keys(keys, valid=None, num_rows=None):
    """(int64 keys as the kernels compare them, matchable bool mask): the
    live rows whose key is valid and no NaN."""
    n = keys.shape[0]
    ok = live_rows(n, num_rows, keys.device)
    if valid is not None:
        ok = ok & valid
    if keys.is_floating_point():
        ok = ok & ~torch.isnan(keys)
        bits = torch.int64 if keys.dtype == torch.float64 else torch.int32
        return flush_float_keys(keys).view(bits).to(torch.int64), ok
    return keys.to(torch.int64), ok


def hash_build_plain(keys, valid=None, num_rows=None) -> SortedTable:
    """Plain version of `hash_build`: the matchable keys sorted (stable),
    their rows, and the duplicate flag from adjacent equal keys."""
    k, ok = _canonical_keys(keys, valid, num_rows)
    rows = torch.nonzero(ok).flatten()
    sk, perm = torch.sort(k[rows], stable=True)
    dup = bool((sk[1:] == sk[:-1]).any()) if sk.shape[0] > 1 else False
    result = torch.tensor([0, int(dup)], dtype=torch.int64,
                          device=keys.device)
    return SortedTable(keys.dtype, sk, rows[perm], result)


def hash_probe_plain(table: SortedTable, keys, valid=None, num_rows=None,
                     capacity=None):
    """Plain version of `hash_probe`: a search of the sorted build keys;
    the pairs in probe-row order, the first of equal build keys."""
    m = keys.shape[0]
    cap = m if capacity is None else int(capacity)
    sk, srows = table.keys, table.rows
    k, ok = _canonical_keys(keys, valid, num_rows)
    at = torch.searchsorted(sk, k).clamp(max=max(sk.shape[0] - 1, 0))
    hit = ok & (sk[at] == k) if sk.shape[0] else torch.zeros_like(ok)
    probe = torch.nonzero(hit).flatten()
    build = srows[at[probe]] if sk.shape[0] else probe
    out_p = torch.full((cap,), -1, dtype=torch.int32, device=keys.device)
    out_b = out_p.clone()
    out_p[:min(cap, probe.shape[0])] = probe[:cap].to(torch.int32)
    out_b[:min(cap, probe.shape[0])] = build[:cap].to(torch.int32)
    result = table.result.clone()
    result[0] = probe.shape[0]
    return out_p, out_b, result


# -- the kernels ----------------------------------------------------------------

def _ptr(t):
    return None if t is None else t.data_ptr()


def hash_build(keys, valid=None, num_rows=None) -> HashTable:
    """The table of the build side's keys (see the module)."""
    _check("hash_build", keys, valid, num_rows)
    dev = _on_card("hash_build", keys, valid, num_rows)
    if dev is None:
        return hash_build_plain(keys, valid, num_rows)
    if keys.shape[0] == 0:
        result = torch.zeros(2, dtype=torch.int64, device=dev)
        return HashTable(keys.dtype, 0, False, None, result)
    lib = _lib.lib()
    dt = KEY_DTYPES[keys.dtype]
    slots = lib.gdf_hash_slots(keys.shape[0])
    data = torch.empty(lib.gdf_hash_table_bytes(dt, slots),
                       dtype=torch.uint8, device=dev)
    result = torch.empty(2, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        _lib.check(lib.gdf_hash_build(
            dt, keys.data_ptr(), _ptr(valid), _ptr(num_rows), keys.shape[0],
            data.data_ptr(), slots, result.data_ptr(),
            _lib.stream_ptr(dev)), "hash_build")
    _lib.count_launch(hash_build)
    return HashTable(keys.dtype, slots, bool(lib.gdf_hash_staged(slots)),
                     data, result)


hash_build.launches = 0


def hash_probe(table, keys, valid=None, num_rows=None, capacity=None):
    """(probe rows, build rows, result) of the probe side's keys against
    `table` (see the module)."""
    _check("hash_probe", keys, valid, num_rows)
    if keys.dtype != table.dtype:
        raise TypeError(f"hash_probe: keys of {keys.dtype} against a table "
                        f"of {table.dtype}")
    cap = keys.shape[0] if capacity is None else int(capacity)
    dev = _on_card("hash_probe", keys, valid, num_rows, table.result)
    if dev is None:
        return hash_probe_plain(table, keys, valid, num_rows, cap)
    if not isinstance(table, HashTable):
        raise TypeError("hash_probe: CUDA keys take a table of hash_build")
    out_p = torch.empty(cap, dtype=torch.int32, device=dev)
    out_b = torch.empty(cap, dtype=torch.int32, device=dev)
    if table.slots == 0 or keys.shape[0] == 0:
        table.result[:1].zero_()
        return out_p, out_b, table.result
    lib = _lib.lib()
    with torch.cuda.device(dev):
        _lib.check(lib.gdf_hash_probe(
            KEY_DTYPES[keys.dtype], keys.data_ptr(), _ptr(valid),
            _ptr(num_rows), keys.shape[0], table.data.data_ptr(),
            table.slots, out_p.data_ptr(), out_b.data_ptr(), cap,
            table.result.data_ptr(), _lib.stream_ptr(dev)), "hash_probe")
    _lib.count_launch(hash_probe)
    return out_p, out_b, table.result


hash_probe.launches = 0
