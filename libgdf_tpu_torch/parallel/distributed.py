"""Distributed relational operators: shuffle join / groupby, broadcast join,
skew-aware repartitioning.

Counterpart of `libgdf_tpu/parallel/distributed.py`, with the same
operators, defaults, capacities, placement, row order and errors:

  - ShardedTable: a global table as P fixed-capacity slabs plus per-shard
    live counts (the capacity + count convention of core/table.py spread
    over the mesh).
  - map_shards: run a shard-local Table -> Table function on every shard.
    The single-GPU operators (ops/*) are the local operators, so the same
    code runs on one shard and on P.
  - shuffle join / groupby: hash-shuffle on the keys (parallel/shuffle.py),
    then the local operator; groupby pre-aggregates before the shuffle.
  - broadcast join: all-gather a small build side instead of shuffling
    the probe side (≅ build-on-smaller, joining.h:57-70).
  - skew: summed key-hash histograms find hot keys; hot probe rows spread,
    hot build rows replicate.

Nothing is traced here, so every capacity check runs at the call. The
JAX package's overflow flag stays: a shard-local function may report
dropped rows (shuffle_shard's return_overflow), and collect() and
total_rows() raise on it. So that every shard raises together under
torch.distributed, each check first takes the max of its need over the
shards.

Each shard-local run gives every local shard a thread and a CUDA
stream of its own on its shard's device (mesh.py), so one shard's kernels
overlap another's and a shard's host syncs wait for its own stream only.
Live counts and what collect() returns are on the mesh's home device.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, replace
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core.bits import flush_denormals
from ..core.column import Column
from ..core.dtypes import DtypeInfo, GDFDtype
from ..core.errors import GDFStatus, require
from ..core.table import Table, table_concat
from ..ops.compaction import compact_table
from ..ops.groupby import groupby as _local_groupby
from ..ops.hashing import partition_ids, partition_sizes
from ..ops.join import join_indices, join_output
from . import comm
from .mesh import DEFAULT_AXIS, Mesh, shard_table
from .shuffle import (all_gather_table, dest_sizes,
                      global_partition_histogram, required_slot_capacity,
                      shuffle_shard)


@dataclass(frozen=True)
class ShardedTable:
    """A mesh-global table: `shards` are the slabs this process holds (all
    P of them in-process, its L under torch.distributed), Tables of one
    capacity with num_rows None; `counts` (int32[P], on the mesh's device)
    holds every shard's live row count.

    `overflow` (optional int32[P], on the host) counts, per shard, the
    exchanges that dropped rows upstream; collect() and total_rows() raise
    if any is non-zero."""

    shards: tuple
    counts: torch.Tensor
    overflow: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        """Rows over all P slabs (the JAX package's global capacity)."""
        return self.shards[0].capacity * self.counts.shape[0]

    @property
    def table(self) -> Table:
        """The local slabs one after another, as one Table on the home
        device (that of `counts`)."""
        if len(self.shards) == 1:
            return self.shards[0]
        return table_concat([s.to(self.counts.device) for s in self.shards])

    def total_rows(self) -> torch.Tensor:
        self._raise_if_overflowed()
        return self.counts.sum()

    def _raise_if_overflowed(self):
        if self.overflow is None:
            return
        ov = self.overflow.numpy()
        if ov.sum() > 0:
            raise ValueError(
                "distributed pipeline dropped rows: an exchange slot "
                f"overflowed (shards {np.nonzero(ov)[0].tolist()}). Re-size "
                "with exact_slot_capacity / exact_groupby_slot_capacity / a "
                "larger out_capacity_per_shard and re-run")


def _local(st: ShardedTable, i: int, rank: int) -> Table:
    """Local slab i (shard `rank`) with its live count."""
    return st.shards[i].with_num_rows(st.counts[rank])


def _tensors(obj):
    """The tensors of a shard-local result: tensors, Tables and tuples or
    lists of them (ints and None hold none)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, Table):
        for c in obj.columns:
            yield c.data
            if c.valid is not None:
                yield c.valid
        if obj.num_rows is not None:
            yield obj.num_rows
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)


def _spmd(mesh: Mesh, axis_name: str, fn: Callable) -> list:
    """Run fn(i, rank) for every local shard i (global shard `rank`), each
    bound to `axis_name`; returns the results in local shard order. One
    thread per local shard, under either backend; the first exception
    aborts the collectives of the other local shards and is raised here,
    its type unchanged.

    A shard on a card runs on its device and its own stream
    (mesh.shard_streams()), which first waits for the caller's current
    stream on every card of the mesh (that made the inputs). When every
    thread is done, the caller's streams wait for every shard's stream,
    and each result tensor is marked as in use by the caller's stream of
    its card, so the allocator does not reuse it for the shard's stream
    while the caller still reads it."""
    comm_ = mesh.new_comm()
    cards = [d for d in dict.fromkeys(mesh.devices) if d.type == "cuda"]
    streams = mesh.shard_streams()
    inputs_ready = []
    for d in cards:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(d))
        inputs_ready.append(event)
    results = [None] * len(mesh.local_ranks)
    errors = []
    lock = threading.Lock()

    def run(i, rank):
        try:
            stream = streams[i]
            on_card = contextlib.nullcontext()
            if stream is not None:
                torch.cuda.set_device(mesh.devices[i])
                for event in inputs_ready:
                    stream.wait_event(event)
                on_card = torch.cuda.stream(stream)
            with on_card, comm.bind(axis_name, comm_, rank):
                results[i] = fn(i, rank)
        except BaseException as e:  # re-raised in the caller below
            with lock:
                errors.append(e)
            comm_.abort()

    threads = [threading.Thread(target=run, args=(i, r), daemon=True,
                                name=f"shard-{r}")
               for i, r in enumerate(mesh.local_ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for d in cards:
        caller = torch.cuda.current_stream(d)
        for stream in streams:
            if stream is not None:
                caller.wait_stream(stream)
    if errors:
        first = next((e for e in errors
                      if not isinstance(e, threading.BrokenBarrierError)),
                     None)
        if first is None:
            raise TimeoutError(
                f"a collective over {axis_name!r} waited more than "
                f"{comm.COLLECTIVE_TIMEOUT} s") from errors[0]
        raise first
    for t in _tensors(results):
        if t.device.type == "cuda":
            t.record_stream(torch.cuda.current_stream(t.device))
    return results


def _assemble(mesh: Mesh, outs, overflows) -> ShardedTable:
    """ShardedTable of the local outputs of a shard-local run; the counts
    and overflow flags of every shard of the mesh (each process's local
    ones gathered, in global shard order), the counts on the mesh's home
    device."""
    caps = {t.capacity for t in outs}
    require(len(caps) == 1, GDFStatus.GDF_COLUMN_SIZE_MISMATCH,
            f"shard-local outputs of different capacities {sorted(caps)}")
    counts = [t.num_rows if t.num_rows is not None else
              torch.tensor(t.capacity, dtype=torch.int32, device=t.device)
              for t in outs]
    counts = torch.stack([c.to(mesh.device) for c in counts])
    if mesh.backend == "process_group":
        pg = mesh.new_comm()
        counts = pg.gather_processes(counts).reshape(-1)
        overflows = [v for row in pg.gather_process_ints(overflows)
                     for v in row]
    return ShardedTable(shards=tuple(t.with_num_rows(None) for t in outs),
                        counts=counts,
                        overflow=torch.tensor(overflows, dtype=torch.int32))


def _distribute(table: Table, mesh: Mesh, axis_name: str,
                what: str) -> ShardedTable:
    nshards = mesh.size
    n = table.capacity
    require(table.num_rows is None, GDFStatus.GDF_INVALID_API_CALL,
            f"{what}() wants a compacted table")
    per = -(-n // nshards)
    pad = per * nshards - n
    if pad:
        cols = []
        for c in table.columns:
            data = torch.cat([c.data, c.data.new_zeros(pad)])
            valid = None if c.valid is None else torch.cat(
                [c.valid, c.valid.new_zeros(pad)])
            cols.append(replace(c, data=data, valid=valid))
        table = replace(table, columns=tuple(cols))
    # shard s holds rows [s * per, (s + 1) * per), live up to row n
    counts = [min(max(n - s * per, 0), per) for s in range(nshards)]
    return ShardedTable(
        shards=shard_table(table, mesh, axis_name),
        counts=torch.tensor(counts, dtype=torch.int32, device=mesh.device))


def distribute(table: Table, mesh: Mesh,
               axis_name: str = DEFAULT_AXIS) -> ShardedTable:
    """Shard a fully-live host/global Table row-wise over the mesh (pads
    the row count up to a multiple of the mesh size); slab s goes to its
    shard's device, the counts to the mesh's home device."""
    return _distribute(table, mesh, axis_name, "distribute")


def distribute_global(table: Table, mesh: Mesh,
                      axis_name: str = DEFAULT_AXIS) -> ShardedTable:
    """Multi-process distribute(): every process holds the same
    host-global Table and keeps only the slabs of its own shards (as
    distribute() does on every mesh)."""
    return _distribute(table, mesh, axis_name, "distribute_global")


def collect(st: ShardedTable) -> Table:
    """Gather all shards into one compacted Table on the home device (that
    of `counts`), each slab's live rows copied there from its shard's.
    Raises if a shard recorded dropped rows, and where this process does
    not hold every shard."""
    st._raise_if_overflowed()
    counts = st.counts.tolist()
    require(len(st.shards) == len(counts), GDFStatus.GDF_INVALID_API_CALL,
            "collect() needs every shard in this process")
    return table_concat([_slice_rows(s, k).to(st.counts.device)
                         for s, k in zip(st.shards, counts)])


def map_shards(mesh: Mesh, fn: Callable[..., Table], *sts: ShardedTable,
               axis_name: str = DEFAULT_AXIS) -> ShardedTable:
    """Run a shard-local Table -> Table function over the mesh. `fn`
    receives each shard's local Table (with its live num_rows) and returns
    a local Table; every shard's must have one capacity.

    `fn` may instead return (Table, overflow): the int is added to the
    output's `overflow` (shuffles report dropped rows this way). Input
    tables' overflow counts carry over either way."""
    def body(i, rank):
        out = fn(*[_local(st, i, rank) for st in sts])
        ov = 0
        if isinstance(out, tuple):
            out, fn_ov = out
            ov += int(fn_ov)
        for st in sts:
            if st.overflow is not None:
                ov += int(st.overflow[rank])
        return out, ov

    res = _spmd(mesh, axis_name, body)
    return _assemble(mesh, [r[0] for r in res], [r[1] for r in res])


# ---------------------------------------------------------------------------
# Distributed groupby
# ---------------------------------------------------------------------------

class _AggPlan:
    """Decompose user aggs into a shuffle-safe two-phase (combiner) plan:
    partial aggregation before the shuffle, exact merge after. AVG travels
    as sum + count and is finalized by a float64 divide (the distributed
    generalization of multi_pass_avg, groupby.cuh:308-419). The partial
    columns' names start with "__"; finalize drops them by that prefix."""

    def __init__(self, aggs):
        self.user = [(a[0], a[1], a[2] if len(a) > 2 else f"{a[1]}_{a[0]}")
                     for a in aggs]
        self.partial = []
        self.merge = []
        self.post_avg = []
        seen = set()

        def add(col, op, name):
            if name not in seen:
                self.partial.append((col, op, name))
                seen.add(name)

        for col, op, out in self.user:
            if op == "avg":
                s, c = f"__s_{col}", f"__c_{col}"
                add(col, "sum", s)
                add(col, "count", c)
                self.merge += [(s, "sum", s), (c, "sum", c)]
                self.post_avg.append((out, s, c))
            elif op in ("count", "count_distinct"):
                tmp = f"__n_{col}"
                add(col, "count", tmp)
                self.merge.append((tmp, "sum", out))
            else:
                tmp = f"__{op}_{col}"
                add(col, op, tmp)
                self.merge.append((tmp, op, out))

    def finalize(self, t: Table) -> Table:
        for out, s, c in self.post_avg:
            scol, ccol = t[s], t[c]
            # a float32 denormal sum is zero (groupby's deferred avg)
            avg = (flush_denormals(scol.data).to(torch.float64)
                   / ccol.data.clamp(min=1).to(torch.float64))
            valid = ccol.data > 0
            if scol.valid is not None:
                valid = valid & scol.valid
            t = t.with_column(Column(data=avg, valid=valid,
                                     info=DtypeInfo(GDFDtype.FLOAT64),
                                     name=out))
        return t.select([n for n in t.names if not n.startswith("__")])


def _round_up(need: int, num_batches: int) -> int:
    need = max(need, 1)
    return -(-need // num_batches) * num_batches


def exact_slot_capacity(mesh: Mesh, sides, axis_name: str = DEFAULT_AXIS,
                        num_batches: int = 1) -> int:
    """Loss-proof slot sizing: the global max rows any shard sends to any
    destination, over every (ShardedTable, key_names[, salt_fn]) in
    `sides`, as an int (rounded up to a num_batches multiple).

    ≅ the reference's exact-histogram-then-scatter discipline
    (hashing.cu:401-536): libgdf never drops rows on partition overflow,
    and neither does this — the price is this counting pre-pass."""
    sides = [s if len(s) == 3 else (s[0], s[1], None) for s in sides]

    def need(i, rank):
        caps = []
        for st, keys, salt_fn in sides:
            t = _local(st, i, rank)
            salt = None if salt_fn is None else salt_fn(t)
            caps.append(int(required_slot_capacity(t, keys, axis_name,
                                                   salt)))
        return max(caps)

    return _round_up(_spmd(mesh, axis_name, need)[0], num_batches)


def _check_slot_capacity(mesh, sides, slot_capacity, axis_name):
    """Loud failure on a user-provided slot_capacity that would drop
    rows."""
    need = exact_slot_capacity(mesh, sides, axis_name)
    require(need <= slot_capacity, GDFStatus.GDF_COLUMN_SIZE_TOO_BIG,
            f"shuffle would drop rows: a shard sends {need} rows to one "
            f"destination but slot_capacity={slot_capacity}; raise it or "
            f"use the salted path (dist_join_salted)")


def exact_groupby_slot_capacity(mesh: Mesh, st: ShardedTable,
                                key_names: Sequence[str], aggs,
                                axis_name: str = DEFAULT_AXIS,
                                num_batches: int = 1) -> int:
    """Exact slot sizing for dist_groupby's pre-aggregated exchange,
    computed from the actual input ShardedTable (e.g. a join output, whose
    per-shard distinct-key count no bound from upstream tables gives).
    The combiner runs in the pre-pass, so the count is exactly what the
    shuffle will send."""
    _, need = _pre_aggregate(mesh, st, key_names, _AggPlan(aggs), axis_name)
    return _round_up(need, num_batches)


def _pre_aggregate(mesh, st, key_names, plan, axis_name):
    """Each shard's combiner output, and the exact slot its shuffle
    needs."""
    def pre(i, rank):
        part = _local_groupby(_local(st, i, rank), key_names, plan.partial)
        return part, int(required_slot_capacity(part, key_names, axis_name))

    res = _spmd(mesh, axis_name, pre)
    return [r[0] for r in res], res[0][1]


def dist_groupby(mesh: Mesh, st: ShardedTable, key_names: Sequence[str],
                 aggs, slot_capacity: int | None = None,
                 axis_name: str = DEFAULT_AXIS,
                 pre_aggregate: bool = True,
                 num_batches: int = 1) -> ShardedTable:
    """Distributed groupby; the result stays sharded (each shard owns a
    disjoint set of groups: the shuffle co-locates equal keys).

    With pre_aggregate=True (default) the combiner collapses each shard's
    rows to one row per distinct key before the shuffle, so hot keys
    cannot overflow a destination; the slot need is counted on the
    combiner's output, which the shuffle then sends.

    slot_capacity=None (default) sizes the exchange exactly (loss-proof);
    an explicit value is checked and raises GDFError if it would drop
    rows."""
    plan = _AggPlan(aggs)
    if pre_aggregate:
        parts, need = _pre_aggregate(mesh, st, key_names, plan, axis_name)
        need = _round_up(need, num_batches)
        if slot_capacity is None:
            slot_capacity = need
        else:
            require(need <= slot_capacity,
                    GDFStatus.GDF_COLUMN_SIZE_TOO_BIG,
                    f"shuffle would drop rows ({need} > {slot_capacity})")
        ov = [0 if st.overflow is None else int(st.overflow[r])
              for r in mesh.local_ranks]
        st = _assemble(mesh, parts, ov)
    else:
        sides = [(st, key_names, None)]
        if slot_capacity is None:
            slot_capacity = exact_slot_capacity(mesh, sides, axis_name,
                                                num_batches)
        else:
            _check_slot_capacity(mesh, sides, slot_capacity, axis_name)

    def body(t: Table):
        t, ov = shuffle_shard(t, key_names, axis_name, slot_capacity,
                              num_batches=num_batches, return_overflow=True)
        if pre_aggregate:
            out = _local_groupby(t, key_names, plan.merge)
        else:
            out = _rename_to_merge(
                _local_groupby(t, key_names, plan.partial), plan)
        return plan.finalize(out), ov

    return map_shards(mesh, body, st, axis_name=axis_name)


def _rename_to_merge(t: Table, plan: _AggPlan) -> Table:
    mapping = {src: dst for (src, _, dst) in plan.merge}
    cols = tuple(c.with_name(mapping.get(n, n))
                 for n, c in zip(t.names, t.columns))
    return replace(t, columns=cols,
                   names=tuple(mapping.get(n, n) for n in t.names))


# ---------------------------------------------------------------------------
# Distributed joins
# ---------------------------------------------------------------------------

def _local_join(lt: Table, rt: Table, left_on, right_on, how: str,
                out_capacity: int, axis_name: str) -> Table:
    """The shard-local join, its output padded to `out_capacity` rows.
    Every shard raises "output overflow" if any shard's count exceeds it
    (join counts are exact, so the check is too)."""
    l_idx, r_idx, count = join_indices(lt, rt, left_on, right_on, how)
    need = comm.pmax(int(count), axis_name)
    if need > out_capacity:
        raise ValueError(
            f"dist_join output overflow: a shard produced {need} rows > "
            f"out_capacity_per_shard={out_capacity}; re-run with a larger "
            f"capacity")
    pad = out_capacity - l_idx.shape[0]
    if pad:
        l_idx = torch.cat([l_idx, l_idx.new_full((pad,), -1)])
        r_idx = torch.cat([r_idx, r_idx.new_full((pad,), -1)])
    return join_output(lt, rt, left_on, right_on, how, l_idx, r_idx, count)


def dist_join(mesh: Mesh, left: ShardedTable, right: ShardedTable,
              left_on, right_on, how: str = "inner",
              out_capacity_per_shard: int | None = None,
              slot_capacity: int | None = None,
              axis_name: str = DEFAULT_AXIS,
              num_batches: int = 1) -> ShardedTable:
    """Distributed shuffle join: both sides shuffled on their keys with the
    same hash and partitioner, then joined shard-locally. FULL joins are
    safe: any key's rows live on exactly one shard.

    slot_capacity=None (default) sizes the exchange exactly from a
    counting pre-pass (loss-proof); an explicit value is checked and
    raises GDFError if it would drop rows. A join count over
    out_capacity_per_shard (default 2 * (left + right rows per shard))
    raises ValueError. Heavily skewed keys make the exact capacity balloon
    (every hot-key row goes to one shard): use dist_join_salted."""
    require(how in ("inner", "left", "full"),
            GDFStatus.GDF_UNSUPPORTED_JOIN_TYPE, how)
    nshards = mesh.size
    lps = left.capacity // nshards
    rps = right.capacity // nshards
    sides = [(left, left_on, None), (right, right_on, None)]
    if slot_capacity is None:
        slot_capacity = exact_slot_capacity(mesh, sides, axis_name,
                                            num_batches)
    else:
        _check_slot_capacity(mesh, sides, slot_capacity, axis_name)
    if out_capacity_per_shard is None:
        out_capacity_per_shard = 2 * (lps + rps)

    def body(lt: Table, rt: Table):
        lt, ov_l = shuffle_shard(lt, left_on, axis_name, slot_capacity,
                                 num_batches=num_batches,
                                 return_overflow=True)
        rt, ov_r = shuffle_shard(rt, right_on, axis_name, slot_capacity,
                                 num_batches=num_batches,
                                 return_overflow=True)
        return _local_join(lt, rt, left_on, right_on, how,
                           out_capacity_per_shard, axis_name), ov_l + ov_r

    return map_shards(mesh, body, left, right, axis_name=axis_name)


class SaltedJoinPlan:
    """Planning product of the skew-aware join: the hot-bin mask plus
    loss-proof capacities, built once by plan_salted_join; execution
    against a plan runs no pre-pass."""

    def __init__(self, mesh, left_on, right_on, how, hot, slot_capacity,
                 hot_capacity_per_shard, out_capacity_per_shard,
                 num_bins, axis_name):
        self.mesh = mesh
        self.left_on = tuple(left_on)
        self.right_on = tuple(right_on)
        self.how = how
        # a copy on every device of the mesh: each shard reads its own
        self._hot = {d: torch.as_tensor(np.asarray(hot), device=d)
                     for d in dict.fromkeys((mesh.device,) + mesh.devices)}
        self.hot = self._hot[mesh.device]
        self.slot_capacity = int(slot_capacity)
        self.hot_capacity_per_shard = int(hot_capacity_per_shard)
        self.out_capacity_per_shard = int(out_capacity_per_shard)
        self.num_bins = int(num_bins)
        self.axis_name = axis_name

    def left_salt(self, t: Table) -> torch.Tensor:
        """Hot rows go round-robin by row position, the others to their
        hash's shard (live rows sit at the front of each shard)."""
        is_hot = self._hot[t.device][partition_ids(t, self.left_on,
                                                    self.num_bins)]
        spread = torch.arange(t.capacity, dtype=torch.int32,
                              device=t.device) % self.mesh.size
        return torch.where(is_hot, spread, 0).to(torch.int32)

    def _right_hot(self, rt: Table) -> torch.Tensor:
        return self._hot[rt.device][partition_ids(rt, self.right_on,
                                                  self.num_bins)] \
            & rt.live_mask()

    def body(self):
        plan = self

        def _body(lt: Table, rt: Table):
            # LEFT: salted shuffle (hot rows spread, cold co-located)
            lt, ov_l = shuffle_shard(lt, plan.left_on, plan.axis_name,
                                     plan.slot_capacity,
                                     salt=plan.left_salt(lt),
                                     return_overflow=True)
            # RIGHT: cold rows shuffle, hot rows replicate
            is_hot = plan._right_hot(rt)
            cold_t, n_cold = compact_table(rt, ~is_hot & rt.live_mask())
            cold_t = cold_t.with_num_rows(n_cold)
            hot_t, n_hot = compact_table(rt, is_hot)
            hot_t = _slice_rows(hot_t, plan.hot_capacity_per_shard)
            hot_t = hot_t.with_num_rows(
                n_hot.clamp(max=plan.hot_capacity_per_shard))
            cold_sh, ov_r = shuffle_shard(cold_t, plan.right_on,
                                          plan.axis_name,
                                          plan.slot_capacity,
                                          return_overflow=True)
            hot_rep = all_gather_table(hot_t, plan.axis_name)
            rt_local = _concat_live(cold_sh, hot_rep)
            return (_local_join(lt, rt_local, plan.left_on, plan.right_on,
                                plan.how, plan.out_capacity_per_shard,
                                plan.axis_name), ov_l + ov_r)

        return _body


def plan_salted_join(mesh: Mesh, left: ShardedTable, right: ShardedTable,
                     left_on, right_on, how: str = "inner",
                     out_capacity_per_shard: int | None = None,
                     slot_capacity: int | None = None,
                     hot_capacity_per_shard: int | None = None,
                     num_bins: int = 1024, threshold: float = 4.0,
                     axis_name: str = DEFAULT_AXIS) -> SaltedJoinPlan:
    """Plan a skew-aware join: find hot bins (summed key-hash histograms
    of both sides) and compute loss-proof capacities."""
    require(how in ("inner", "left"), GDFStatus.GDF_UNSUPPORTED_JOIN_TYPE,
            "salted join supports inner/left only")
    nshards = mesh.size
    lps = left.capacity // nshards
    rps = right.capacity // nshards
    _, hot = detect_skew(mesh, right, right_on, axis_name=axis_name,
                         num_bins=num_bins, threshold=threshold)
    # also salt by LEFT-side heat: a key hot on the probe side floods one
    # shard even when the build side is uniform.
    _, hot_l = detect_skew(mesh, left, left_on, axis_name=axis_name,
                           num_bins=num_bins, threshold=threshold)
    # The plan is built first so that the sizing pre-pass salts with the
    # very plan.left_salt the execution will use.
    plan = SaltedJoinPlan(mesh, left_on, right_on, how,
                          np.logical_or(hot, hot_l), 1, 1, 1, num_bins,
                          axis_name)

    def sizing(i, rank):
        lt, rt = _local(left, i, rank), _local(right, i, rank)
        l_need = dest_sizes(lt, left_on, axis_name,
                            salt=plan.left_salt(lt)).max()
        # cold destination sizes: live rows that are not hot
        is_hot = plan._right_hot(rt)
        r_need = partition_sizes(partition_ids(rt, right_on, nshards),
                                 nshards, rt.live_mask() & ~is_hot).max()
        need = comm.pmax(int(torch.maximum(l_need, r_need)), axis_name)
        hot_cnt = comm.pmax(int(is_hot.sum()), axis_name)
        return need, hot_cnt

    need, hot_max = _spmd(mesh, axis_name, sizing)[0]
    if slot_capacity is None:
        slot_capacity = max(need, 1)
    else:
        require(need <= slot_capacity, GDFStatus.GDF_COLUMN_SIZE_TOO_BIG,
                f"salted shuffle would drop rows ({need} > "
                f"{slot_capacity})")
    if hot_capacity_per_shard is None:
        hot_capacity_per_shard = max(hot_max, 1)
    else:
        require(hot_max <= hot_capacity_per_shard,
                GDFStatus.GDF_COLUMN_SIZE_TOO_BIG,
                f"hot-row replication would drop rows ({hot_max} > "
                f"{hot_capacity_per_shard})")
    if out_capacity_per_shard is None:
        out_capacity_per_shard = 2 * (lps + rps) + nshards * \
            hot_capacity_per_shard
    plan.slot_capacity = int(slot_capacity)
    plan.hot_capacity_per_shard = int(hot_capacity_per_shard)
    plan.out_capacity_per_shard = int(out_capacity_per_shard)
    return plan


def dist_join_salted(mesh: Mesh, left: ShardedTable, right: ShardedTable,
                     left_on, right_on, how: str | None = None,
                     out_capacity_per_shard: int | None = None,
                     slot_capacity: int | None = None,
                     hot_capacity_per_shard: int | None = None,
                     num_bins: int = 1024, threshold: float = 4.0,
                     axis_name: str = DEFAULT_AXIS,
                     plan: SaltedJoinPlan | None = None) -> ShardedTable:
    """Skew-aware shuffle join (BASELINE config 5's Zipf pipeline).

    Hot keys (from the summed key-hash histogram, ≅ the host-side
    reaction the reference designed its partition histogram for,
    hashing.cu:488-503) are salted: hot LEFT rows spread round-robin over
    all shards; hot RIGHT rows are replicated to every shard (an
    all-gather of the hot subset). Cold keys take the co-located shuffle.
    inner/left only: a FULL join would emit unmatched replicated build
    rows once per shard.

    Without `plan`, planning runs here; with a plan from plan_salted_join,
    keys, how, axis and capacities are the plan's, and an explicit
    argument that disagrees raises."""
    if plan is None:
        plan = plan_salted_join(
            mesh, left, right, left_on, right_on,
            how="inner" if how is None else how,
            out_capacity_per_shard=out_capacity_per_shard,
            slot_capacity=slot_capacity,
            hot_capacity_per_shard=hot_capacity_per_shard,
            num_bins=num_bins, threshold=threshold, axis_name=axis_name)
    else:
        require(tuple(left_on) == plan.left_on
                and tuple(right_on) == plan.right_on
                and how in (None, plan.how)
                and axis_name == plan.axis_name,
                GDFStatus.GDF_INVALID_API_CALL,
                "dist_join_salted: keys/how/axis disagree with the plan")
        require(slot_capacity in (None, plan.slot_capacity)
                and hot_capacity_per_shard in (
                    None, plan.hot_capacity_per_shard)
                and out_capacity_per_shard in (
                    None, plan.out_capacity_per_shard),
                GDFStatus.GDF_INVALID_API_CALL,
                "dist_join_salted: explicit capacities disagree with "
                "the plan's (re-plan instead)")
    return map_shards(mesh, plan.body(), left, right,
                      axis_name=plan.axis_name)


def _concat_live(a: Table, b: Table) -> Table:
    """Concatenate two capacity + count tables: stack the slabs and
    re-compact (H1) so that live rows are contiguous."""
    cols = []
    for ca, cb in zip(a.columns, b.columns):
        has_valid = ca.valid is not None or cb.valid is not None
        cols.append(replace(
            ca, data=torch.cat([ca.data, cb.data]),
            valid=torch.cat([ca.valid_or_true(), cb.valid_or_true()])
            if has_valid else None))
    keep = torch.cat([a.live_mask(), b.live_mask()])
    out, count = compact_table(Table(columns=tuple(cols), names=a.names),
                               keep)
    return out.with_num_rows(count)


def _slice_rows(t: Table, cap: int) -> Table:
    cols = tuple(replace(c, data=c.data[:cap],
                         valid=None if c.valid is None else c.valid[:cap])
                 for c in t.columns)
    return Table(columns=cols, names=t.names)


def broadcast_join(mesh: Mesh, left: ShardedTable, right: ShardedTable,
                   left_on, right_on, how: str = "inner",
                   out_capacity_per_shard: int | None = None,
                   axis_name: str = DEFAULT_AXIS) -> ShardedTable:
    """Replicated-build join: all-gather the (small) right side; the big
    probe side never moves. inner/left only (FULL would count unmatched
    build rows once per shard)."""
    require(how in ("inner", "left"), GDFStatus.GDF_UNSUPPORTED_JOIN_TYPE,
            "broadcast join supports inner/left only")
    lps = left.capacity // mesh.size
    if out_capacity_per_shard is None:
        out_capacity_per_shard = 2 * (lps + right.capacity)

    def body(lt: Table, rt: Table) -> Table:
        rt_full = all_gather_table(rt, axis_name)
        return _local_join(lt, rt_full, left_on, right_on, how,
                           out_capacity_per_shard, axis_name)

    return map_shards(mesh, body, left, right, axis_name=axis_name)


# ---------------------------------------------------------------------------
# Skew detection (BASELINE config 5)
# ---------------------------------------------------------------------------

def detect_skew(mesh: Mesh, st: ShardedTable, key_names,
                axis_name: str = DEFAULT_AXIS,
                num_bins: int | None = None, threshold: float = 4.0):
    """Global key-hash histogram (summed over shards) as numpy int32 and
    the bins over threshold x mean, which are hot. A planning-time
    readout, as the reference exposes partition sizes to its host caller
    (hashing.cu:499-503)."""
    nbins = num_bins or mesh.size

    def hist(i, rank):
        return global_partition_histogram(_local(st, i, rank), key_names,
                                          axis_name, nbins)

    h = _spmd(mesh, axis_name, hist)[0].cpu().numpy()
    mean = max(float(h.mean()), 1.0)
    return h, h > threshold * mean

