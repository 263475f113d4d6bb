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
  ProcessGroupComm  one shard per process over torch.distributed:
                    all_to_all_single with exact split sizes, all_gather
                    and all_reduce (SUM, MAX).

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
    """P ranks of one process, one thread each, rank r on `devices[r]`
    and on that thread's current stream there.
    Values pass through a pair of slot arrays used in turn: a rank reaches
    round r + 2, which reuses round r's array, only after every rank has
    left round r + 1, so no rank can overwrite a value a peer has yet to
    read. The integer collectives carry Python ints."""

    def __init__(self, size: int, stats: ExchangeStats, devices: tuple):
        self.size = size
        self.stats = stats
        self.devices = devices
        self._barrier = threading.Barrier(size, timeout=COLLECTIVE_TIMEOUT)
        self._slots = ([None] * size, [None] * size)
        self._round = [0] * size

    def abort(self) -> None:
        """Wake every rank waiting in a collective with BrokenBarrierError
        (a rank that raised will not arrive)."""
        self._barrier.abort()

    def _exchange(self, rank: int, value, tensors: bool = False) -> list:
        """Every rank's value, in rank order. With `tensors`, the value
        holds tensors on this rank's device, and each entry is (value,
        event): the event recorded on this rank's stream after the
        value's last write (None off the card)."""
        if tensors:
            dev = self.devices[rank]
            event = None
            if dev.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
            value = (value, event)
        slots = self._slots[self._round[rank] % 2]
        self._round[rank] += 1
        slots[rank] = value
        self._barrier.wait()
        return list(slots)

    def _take(self, rank: int, x: torch.Tensor, event) -> torch.Tensor:
        """A peer's tensor x, ready to read on this rank's stream and
        device: the stream waits for the peer's event, then reads x in
        place or, from another card, a peer copy of it (which runs on this
        thread's current stream of x's card)."""
        if event is None:
            return x
        dev = self.devices[rank]
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
        got = self._exchange(rank, list(values))
        return [got[p][rank] for p in range(self.size)]

    @_timed
    def all_gather(self, rank, x):
        """[rank 0's x, rank 1's x, ...]; x has one shape on every rank."""
        return self._gather(rank, x)

    @_timed
    def all_gather_ints(self, rank, value):
        return self._exchange(rank, int(value))

    @_timed
    def psum(self, rank, x):
        if isinstance(x, torch.Tensor):
            return torch.stack(self._gather(rank, x)).sum(0, dtype=x.dtype)
        return sum(self._exchange(rank, x))

    @_timed
    def pmax(self, rank, x):
        if isinstance(x, torch.Tensor):
            return torch.stack(self._gather(rank, x)).amax(0)
        return max(self._exchange(rank, x))


class ProcessGroupComm:
    """One rank per process over torch.distributed's default group (gloo
    for CPU tensors, NCCL for CUDA tensors). Bool tensors travel as
    uint8."""

    def __init__(self, device: torch.device, stats: ExchangeStats):
        import torch.distributed as dist
        self._dist = dist
        self.size = dist.get_world_size()
        self.device = device
        self.stats = stats

    @_timed
    def all_to_all(self, rank, chunks, recv_sizes, out):
        n = sum(recv_sizes)
        flat = torch.cat(chunks)
        dst = out[:n]
        if flat.dtype == torch.bool:
            flat, dst = flat.view(torch.uint8), dst.view(torch.uint8)
        self._dist.all_to_all_single(
            dst, flat, output_split_sizes=list(recv_sizes),
            input_split_sizes=[c.shape[0] for c in chunks])
        return out[:n]

    @_timed
    def all_to_all_ints(self, rank, values):
        send = torch.tensor(list(values), dtype=torch.int64,
                            device=self.device)
        recv = torch.empty_like(send)
        self._dist.all_to_all_single(recv, send)
        return recv.tolist()

    @_timed
    def all_gather(self, rank, x):
        src = x.view(torch.uint8) if x.dtype == torch.bool else x
        outs = [torch.empty_like(src) for _ in range(self.size)]
        self._dist.all_gather(outs, src.contiguous())
        if x.dtype == torch.bool:
            outs = [o.view(torch.bool) for o in outs]
        return outs

    @_timed
    def all_gather_ints(self, rank, value):
        x = torch.tensor([int(value)], dtype=torch.int64, device=self.device)
        outs = [torch.empty_like(x) for _ in range(self.size)]
        self._dist.all_gather(outs, x)
        return [int(o) for o in torch.cat(outs).tolist()]

    def _reduce(self, x, op):
        if isinstance(x, torch.Tensor):
            y = x.reshape(-1).clone()
            self._dist.all_reduce(y, op=op)
            return y.reshape(x.shape)
        y = torch.tensor([int(x)], dtype=torch.int64, device=self.device)
        self._dist.all_reduce(y, op=op)
        return int(y.item())

    @_timed
    def psum(self, rank, x):
        return self._reduce(x, self._dist.ReduceOp.SUM)

    @_timed
    def pmax(self, rank, x):
        return self._reduce(x, self._dist.ReduceOp.MAX)


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
