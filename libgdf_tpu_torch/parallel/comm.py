"""The collectives of the distributed layer, behind one small communicator.

The JAX package's shard-local bodies take five collectives from `jax.lax`
(libgdf_tpu/parallel/shuffle.py:36,61,123,142,178-185,204 and
distributed.py:646-648): the axis size, an all-to-all (of the sizes, then
of the data), an all-gather, a sum and a max over the shards. Here they
are methods of a communicator with two backends:

  ThreadComm        P shards in one process, one thread per shard, each
                    on a CUDA stream of its own on its shard's device. A
                    collective puts the rank's value into a shared slot
                    array, waits on a barrier and reads its peers' values:
                    an all-to-all is a transpose of lists of tensors, with
                    no copy but the one into the output (and, from a peer
                    on another card, the copy to this rank's card).
  ProcessGroupComm  W processes of a torch.distributed group, L shards
                    in each (a thread a shard, as above): the local
                    shards meet as under ThreadComm, and one thread of
                    each process makes the collective's one call of the
                    group (all_to_all_single with exact split sizes, or
                    all_gather), over the tensors' bytes.

A shard-local body finds its communicator and its rank by axis name
(`bind`, then the module-level functions below), as a `shard_map` body
finds its mesh axis. Under ThreadComm a rank publishes a tensor with a
CUDA event recorded on its own stream after its last write, and a reader
makes its own stream wait for that event (no host sync) before it reads:
in place where the peer shares its card, after a peer copy to its own
card where it does not. The reader marks what it reads as in use by the
stream that reads it (`record_stream`), so that the caching allocator
does not hand the block back to the producer, when the producer drops
it, before that read has run. On CPU tensors there are no events.

Each communicator adds the host time its calls take (barrier waits and
the enqueue of the copies; the copies themselves run on the device) to an
`ExchangeStats`, the exchange share that the distributed path reports.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time

import torch

# A collective that waits longer than this fails instead of hanging.
COLLECTIVE_TIMEOUT = 300.0

_LOCAL = threading.local()


class ExchangeStats:
    """Host seconds spent in collectives, summed over ranks, and calls."""

    def __init__(self):
        self._lock = threading.Lock()
        self.seconds = 0.0
        self.calls = 0

    def add(self, seconds: float) -> None:
        with self._lock:
            self.seconds += seconds
            self.calls += 1

    def reset(self) -> None:
        with self._lock:
            self.seconds, self.calls = 0.0, 0


def _timed(method):
    @functools.wraps(method)
    def wrapper(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return method(self, *args, **kw)
        finally:
            self.stats.add(time.perf_counter() - t0)
    return wrapper


class ThreadComm:
    """The ranks of one process, one thread each, local rank i (global
    rank base + i) on `devices[i]` and on that thread's current stream
    there; in-process, base is 0 and every rank of the mesh is local.
    Values pass through a pair of slot arrays used in turn: a rank reaches
    round r + 2, which reuses round r's array, only after every local rank
    has left round r + 1, so no rank can overwrite a value a peer has yet
    to read. The integer collectives carry Python ints."""

    def __init__(self, size: int, stats: ExchangeStats, devices: tuple,
                 base: int = 0):
        self.size = size
        self.stats = stats
        self.devices = devices
        self.base = base
        local = len(devices)
        self._barrier = threading.Barrier(local, timeout=COLLECTIVE_TIMEOUT)
        self._slots = ([None] * local, [None] * local)
        self._round = [0] * local

    def abort(self) -> None:
        """Wake every rank waiting in a collective with BrokenBarrierError
        (a rank that raised will not arrive)."""
        self._barrier.abort()

    def _exchange(self, rank: int, value, tensors: bool = False) -> list:
        """Every local rank's value, in rank order. With `tensors`, the
        value holds tensors on this rank's device, and each entry is
        (value, event): the event recorded on this rank's stream after the
        value's last write (None off the card)."""
        i = rank - self.base
        if tensors:
            dev = self.devices[i]
            event = None
            if dev.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
            value = (value, event)
        slots = self._slots[self._round[i] % 2]
        self._round[i] += 1
        slots[i] = value
        self._barrier.wait()
        return list(slots)

    def _take(self, rank: int, x: torch.Tensor, event) -> torch.Tensor:
        """A peer's tensor x, ready to read on this rank's stream and
        device: the stream waits for the peer's event, then reads x in
        place or, from another card, a peer copy of it (which runs on this
        thread's current stream of x's card)."""
        if event is None:
            return x
        dev = self.devices[rank - self.base]
        stream = torch.cuda.current_stream(dev)
        stream.wait_event(event)
        if x.device == dev:
            x.record_stream(stream)
            return x
        y = x.to(dev, non_blocking=True)
        x.record_stream(torch.cuda.current_stream(x.device))
        return y

    def _gather(self, rank: int, x) -> list:
        """Every rank's tensor x, each on this rank's device."""
        got = self._exchange(rank, x, tensors=True)
        return [v if p == rank else self._take(rank, v, e)
                for p, (v, e) in enumerate(got)]

    def _ints(self, rank: int, values) -> list:
        """Every rank's list of ints (one length on every rank)."""
        return self._exchange(rank, [int(v) for v in values])

    @_timed
    def all_to_all(self, rank, chunks, recv_sizes, out):
        """Send chunks[p] to rank p; write what rank p sent to this rank,
        in rank order, into the prefix of `out`, and return that prefix."""
        got = self._exchange(rank, chunks, tensors=True)
        recv = [c[rank] if p == rank else self._take(rank, c[rank], e)
                for p, (c, e) in enumerate(got)]
        n = sum(recv_sizes)
        if n:
            torch.cat(recv, out=out[:n])
        return out[:n]

    @_timed
    def all_to_all_ints(self, rank, values):
        return [row[rank] for row in self._ints(rank, values)]

    @_timed
    def all_gather(self, rank, x):
        """[rank 0's x, rank 1's x, ...]; x has one shape on every rank."""
        return self._gather(rank, x)

    @_timed
    def all_gather_ints(self, rank, value):
        return [row[0] for row in self._ints(rank, [value])]

    @_timed
    def psum(self, rank, x):
        if isinstance(x, torch.Tensor):
            return torch.stack(self._gather(rank, x)).sum(0, dtype=x.dtype)
        return sum(row[0] for row in self._ints(rank, [x]))

    @_timed
    def pmax(self, rank, x):
        if isinstance(x, torch.Tensor):
            return torch.stack(self._gather(rank, x)).amax(0)
        return max(row[0] for row in self._ints(rank, [x]))


class ProcessGroupComm(ThreadComm):
    """W processes of torch.distributed's default group (gloo for CPU
    tensors, NCCL for CUDA tensors), L local ranks in each, one thread a
    rank as under ThreadComm: process q holds global ranks q * L ..
    q * L + L - 1 (`base` = q * L), so the ranks run process by process,
    as jax.devices() does.

    A collective first gathers the local ranks' values (ThreadComm's
    exchange). Then local rank 0, the leader, makes the collective's one
    call of the process group, on its device and its thread's current
    stream, records an event after it and hands the result to the other
    local ranks through a second exchange; each reads its part once its
    stream has waited for that event. Only the leader calls the group, in
    the order the shard-local body makes its collectives, which is the
    same in every process (NCCL needs that). Tensors travel as their bytes
    (a uint8 view, split sizes scaled by the element size): every column
    dtype crosses bit for bit, int16 too, which neither gloo nor NCCL
    takes. psum and pmax gather, then reduce in rank order, as ThreadComm
    does, and all_to_all delivers in global source-rank order: every
    result equals that of an in-process mesh of W x L ranks."""

    def __init__(self, stats: ExchangeStats, devices: tuple, base: int):
        import torch.distributed as dist
        self._dist = dist
        self.procs = dist.get_world_size()
        super().__init__(self.procs * len(devices), stats, devices, base)
        self.device = devices[0]

    # -- the process group's calls: one thread of each process makes them

    def gather_processes(self, x: torch.Tensor) -> torch.Tensor:
        """(W, *x.shape): every process's x (one shape in every process),
        in process order, on x's device."""
        src = x.contiguous().reshape(-1).view(torch.uint8)
        outs = [torch.empty_like(src) for _ in range(self.procs)]
        if src.numel():
            self._dist.all_gather(outs, src)
        return torch.cat(outs).view(x.dtype).reshape(self.procs, *x.shape)

    def gather_process_ints(self, values) -> list:
        """Every process's list of ints (one length in every process), on
        the leader's device: across processes on the cards NCCL carries
        them, which measured faster than gloo's CPU route, host wait for
        the leader's stream included (PERF.md §7)."""
        x = torch.tensor([int(v) for v in values], dtype=torch.int64,
                         device=self.device)
        return self.gather_processes(x).tolist()

    # -- the collectives of the local ranks

    def _lead(self, rank: int, fn):
        """fn() run by the leader alone; every local rank gets (its result,
        the event recorded on the leader's stream after it, None off the
        card or for a result that holds no tensor)."""
        out = None
        if rank == self.base:
            res, event = fn(), None
            if isinstance(res, torch.Tensor) and self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            out = (res, event)
        return self._exchange(rank, out)[0]

    def _ints(self, rank, values):
        rows = self._exchange(rank, [int(v) for v in values])
        got, _ = self._lead(rank, lambda: self.gather_process_ints(
            [v for row in rows for v in row]))
        n = len(rows[0])
        return [flat[i * n:(i + 1) * n] for flat in got
                for i in range(len(rows))]

    def _gather(self, rank, x):
        got = self._exchange(rank, x, tensors=True)

        def lead():
            mine = torch.stack([self._take(rank, v, e) for v, e in got])
            return self.gather_processes(mine).reshape(self.size, *x.shape)

        full, event = self._lead(rank, lead)
        return list(self._take(rank, full, event).unbind(0))

    @_timed
    def all_to_all(self, rank, chunks, recv_sizes, out):
        """As ThreadComm's. Process q sends process b, in one
        all_to_all_single of bytes, what each of its local ranks i sends
        to ranks b * L .. b * L + L - 1, i by i (each rank's chunks
        flattened first), so process b receives, source process by source
        process, local source by local source, what each of its ranks
        gets; each rank takes its segments in that order, which is global
        source-rank order."""
        local = len(self.devices)
        flat = torch.cat(chunks)
        got = self._exchange(
            rank, (flat, [c.shape[0] for c in chunks], list(recv_sizes)),
            tensors=True)
        sent = [v[1] for v, _ in got]
        recv = [v[2] for v, _ in got]
        # rows from (source process a, its local rank i) to local rank j
        sizes = [[[recv[j][a * local + i] for j in range(local)]
                  for i in range(local)] for a in range(self.procs)]

        def lead():
            flats = [self._take(rank, v[0], e) for v, e in got]
            # rows local rank i sends to process b, and where they start
            to = [[sum(s[b * local:(b + 1) * local])
                   for b in range(self.procs)] for s in sent]
            at = [list(itertools.accumulate(t, initial=0)) for t in to]
            send = torch.cat([f[a[b]:a[b + 1]] for b in range(self.procs)
                              for f, a in zip(flats, at)])
            send_split = [sum(t[b] for t in to) for b in range(self.procs)]
            recv_split = [sum(map(sum, sizes[a])) for a in range(self.procs)]
            buf = torch.empty(sum(recv_split), dtype=flat.dtype,
                              device=self.device)
            width = flat.element_size()
            self._dist.all_to_all_single(
                buf.view(torch.uint8), send.view(torch.uint8),
                output_split_sizes=[n * width for n in recv_split],
                input_split_sizes=[n * width for n in send_split])
            return buf

        buf, event = self._lead(rank, lead)
        j = rank - self.base
        segments, pos = [], 0
        for a in range(self.procs):
            for i in range(local):
                for jj, k in enumerate(sizes[a][i]):
                    if jj == j and k:
                        segments.append(self._take(rank, buf[pos:pos + k],
                                                   event))
                    pos += k
        n = sum(recv_sizes)
        if n:
            torch.cat(segments, out=out[:n])
        return out[:n]


@contextlib.contextmanager
def bind(axis_name: str, comm, rank: int):
    """Within the block, collectives over `axis_name` on this thread go to
    `comm` as rank `rank`."""
    axes = getattr(_LOCAL, "axes", None)
    if axes is None:
        axes = _LOCAL.axes = {}
    prev = axes.get(axis_name)
    axes[axis_name] = (comm, rank)
    try:
        yield
    finally:
        if prev is None:
            del axes[axis_name]
        else:
            axes[axis_name] = prev


def current(axis_name: str):
    """(communicator, rank) bound to `axis_name` on this thread."""
    try:
        return _LOCAL.axes[axis_name]
    except (AttributeError, KeyError):
        raise ValueError(
            f"no shard axis {axis_name!r} here: collectives run inside a "
            f"shard-local body (map_shards)") from None


def axis_size(axis_name: str) -> int:
    return current(axis_name)[0].size


def axis_index(axis_name: str) -> int:
    return current(axis_name)[1]


def all_to_all(chunks, recv_sizes, out, axis_name: str):
    """chunks[p] goes to rank p; returns out[:sum(recv_sizes)] holding what
    each rank sent here, in rank order (recv_sizes from all_to_all_ints)."""
    comm, rank = current(axis_name)
    return comm.all_to_all(rank, chunks, recv_sizes, out)


def all_to_all_ints(values, axis_name: str) -> list:
    """values[p] goes to rank p; returns [what rank p sent here, ...]."""
    comm, rank = current(axis_name)
    return comm.all_to_all_ints(rank, values)


def all_gather(x: torch.Tensor, axis_name: str) -> list:
    comm, rank = current(axis_name)
    return comm.all_gather(rank, x)


def all_gather_ints(value: int, axis_name: str) -> list:
    comm, rank = current(axis_name)
    return comm.all_gather_ints(rank, value)


def psum(x, axis_name: str):
    """Sum over the shards of a tensor (same shape everywhere) or an int."""
    comm, rank = current(axis_name)
    return comm.psum(rank, x)


def pmax(x, axis_name: str):
    """Max over the shards of a tensor (same shape everywhere) or an int."""
    comm, rank = current(axis_name)
    return comm.pmax(rank, x)
