"""Distributed shuffle: hash-partition + all-to-all exchange.

Counterpart of `libgdf_tpu/parallel/shuffle.py`, with the same placement
and the same row order. Every function here runs inside a shard-local
body (map_shards), as the JAX ones run inside shard_map:

    per-shard hash partition (ops/hashing.py: bit-exact Murmur3 % P, so a
    row lands on the shard the JAX package and a libgdf-based system pick)
        -> a stable sort by destination
        -> one all-to-all of exact split sizes (parallel/comm.py), first of
           the sizes, then of each column
        -> each shard receives its rows in source-shard order, each
           source's rows in source-row order.

The JAX package pads every destination to `slot_capacity` rows, because
its shapes are static, and compacts what it receives. Here only live rows
travel; the output keeps the JAX package's capacity, P * slot_capacity
rows per shard, so that capacities and the joins' default output sizes
follow the reference. A destination with more than `slot_capacity` rows
still receives only the first `slot_capacity` of them, and
`return_overflow` counts such destinations.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Sequence

import torch

from ..core.errors import GDFStatus, require
from ..core.table import Table
from ..ops.hashing import partition_ids, partition_sizes
from . import comm


def _parts(table: Table, key_names, nparts: int, salt) -> torch.Tensor:
    part = partition_ids(table, key_names, nparts)
    if salt is not None:
        part = (part + salt) % nparts
    return part


def dest_sizes(table: Table, key_names: Sequence[str], axis_name: str,
               salt: torch.Tensor | None = None) -> torch.Tensor:
    """Shard-local row counts per destination shard (int32[P]) under the
    shuffle's routing (hash % P, plus optional salt) (≅ the reference's
    partition histogram, compute_row_partition_numbers,
    hashing.cu:259-320)."""
    P = comm.axis_size(axis_name)
    return partition_sizes(_parts(table, key_names, P, salt), P,
                           table.live_mask())


def required_slot_capacity(table: Table, key_names: Sequence[str],
                           axis_name: str,
                           salt: torch.Tensor | None = None) -> torch.Tensor:
    """Global max rows any shard sends to any destination: the exact
    slot_capacity that makes shuffle_shard loss-proof (0-d int32, the same
    on every shard)."""
    return comm.pmax(dest_sizes(table, key_names, axis_name, salt).max(),
                     axis_name)


def shuffle_shard(table: Table, key_names: Sequence[str], axis_name: str,
                  slot_capacity: int, salt: torch.Tensor | None = None,
                  num_batches: int = 1, return_overflow: bool = False):
    """Shard-local body of a distributed shuffle (call inside map_shards).

    After it returns, every live row whose key hashes to partition p lives
    on shard p (hash % num_shards, the reference's modulo partitioner,
    hashing.cu:192-206), in source-shard then source-row order. The result
    has capacity num_shards * slot_capacity and its live count in
    num_rows. `salt` (optional int32[n]) is added to the partition id
    (hot-key salting, distributed.py).

    A destination with more than `slot_capacity` rows receives only its
    first `slot_capacity`: size it with required_slot_capacity (the
    distributed operators do by default). With return_overflow=True the
    return is (Table, overflow), overflow being the int count of this
    shard's over-capacity destinations. `num_batches` must divide
    slot_capacity, as in the JAX package, where it splits the exchange into
    pipelined batches; the exchange here is one all-to-all of exact sizes
    and the output is the same for every value."""
    P = comm.axis_size(axis_name)
    S = int(slot_capacity)
    require(S * P >= 1, GDFStatus.GDF_INVALID_API_CALL)
    require(S % num_batches == 0, GDFStatus.GDF_INVALID_API_CALL,
            "slot_capacity must divide into num_batches")
    dev = table.device

    part = _parts(table, key_names, P, salt)
    part = torch.where(table.live_mask(), part, P)  # dead rows go nowhere
    _, perm = torch.sort(part, stable=True)
    sizes = torch.bincount(part.to(torch.int64), minlength=P + 1)[:P].tolist()
    sent = [min(s, S) for s in sizes]
    if sent == sizes:
        send_rows = perm[:sum(sizes)]
    else:
        starts = [sum(sizes[:p]) for p in range(P)]
        send_rows = torch.cat([perm[a:a + k] for a, k in zip(starts, sent)])
    recv = comm.all_to_all_ints(sent, axis_name)

    def exchange(arr):
        out = torch.zeros(P * S, dtype=arr.dtype, device=dev)
        comm.all_to_all(list(arr[send_rows].split(sent)), recv, out,
                        axis_name)
        return out

    cols = tuple(replace(c, data=exchange(c.data),
                         valid=None if c.valid is None else exchange(c.valid))
                 for c in table.columns)
    out = Table(columns=cols, names=table.names).with_num_rows(sum(recv))
    if return_overflow:
        return out, sum(s > S for s in sizes)
    return out


def all_gather_table(table: Table, axis_name: str) -> Table:
    """Replicate a (small) shard-local table on every shard: the live rows
    of shard 0, then shard 1, ..., at the front of a P * capacity slab.
    Every column comes back with a validity mask, as in the JAX package.

    ≅ the reference's build-on-smaller-side policy (joining.h:57-70)
    lifted to the distributed setting: broadcast the small build side
    instead of shuffling the big probe side."""
    P = comm.axis_size(axis_name)
    n = table.capacity
    counts = comm.all_gather_ints(int(table.row_count()), axis_name)
    total = sum(counts)

    def gather(arr):
        out = torch.zeros(P * n, dtype=arr.dtype, device=arr.device)
        torch.cat([a[:k] for a, k in zip(comm.all_gather(arr, axis_name),
                                         counts)], out=out[:total])
        return out

    cols = tuple(replace(c, data=gather(c.data),
                         valid=gather(c.valid_or_true()))
                 for c in table.columns)
    return Table(columns=cols, names=table.names).with_num_rows(total)


def global_partition_histogram(table: Table, key_names: Sequence[str],
                               axis_name: str,
                               num_bins: int) -> torch.Tensor:
    """Histogram of key-hash bins summed over all shards (int32[num_bins])
    — drives skew detection (≅ the global histogram of
    compute_row_partition_numbers, hashing.cu:259-320, made
    cluster-wide)."""
    local = partition_sizes(partition_ids(table, key_names, num_bins),
                            num_bins, table.live_mask())
    return comm.psum(local, axis_name)
