"""The mesh of row shards.

Counterpart of `libgdf_tpu/parallel/mesh.py`, whose mesh is a 1-D
`jax.sharding.Mesh` of devices. Here a mesh is P row shards with one of
two backends (parallel/comm.py):

  threads        every shard in this process, one thread per shard in a
                 shard-local body, each thread on a CUDA stream of its own
                 on its shard's device: shard s on card s % C of the C
                 cards of the node (`placement`), so make_mesh(C) is one
                 shard per card, as the JAX package's mesh spans
                 jax.devices(); or every shard on one given device (P
                 shards on one H100, as the JAX tests put 8 virtual
                 devices on one CPU);
  process_group  W processes of an initialized torch.distributed group
                 (init_distributed), L shards in each, a thread and a
                 stream a shard as above: global shard s = rank * L + i
                 (process by process, as jax.devices() runs), on
                 cuda:(s % C) of the C cards the process sees.
"""
from __future__ import annotations

import datetime
import socket
from dataclasses import dataclass, field, replace

import torch

from ..core.column import host_data_device
from ..core.errors import GDFStatus, require
from .comm import (COLLECTIVE_TIMEOUT, ExchangeStats, ProcessGroupComm,
                   ThreadComm)

DEFAULT_AXIS = "shards"
# Shards of an in-process mesh unless the caller says: the JAX tests' 8
# virtual devices (tests/conftest.py).
IN_PROCESS_SHARDS = 8


@dataclass(frozen=True)
class Mesh:
    """P row shards. `local_ranks` are the shards this process holds (all
    of them under `threads`, its L shards rank * L .. rank * L + L - 1
    under `process_group`); `devices` holds one device per local shard
    (by default `device` for each). `device` is the home device: local
    shard 0's, where the live counts of a ShardedTable and what collect()
    returns live. `exchange` sums the host time the local shards spend in
    collectives. Raises if a device is a card this node does not have."""

    size: int
    device: torch.device
    backend: str
    local_ranks: tuple
    devices: tuple = ()
    exchange: ExchangeStats = field(default_factory=ExchangeStats,
                                    compare=False, repr=False)
    _streams: dict = field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        if not self.devices:
            object.__setattr__(self, "devices",
                               (self.device,) * len(self.local_ranks))
        require(len(self.devices) == len(self.local_ranks),
                GDFStatus.GDF_INVALID_API_CALL,
                f"{len(self.devices)} devices for "
                f"{len(self.local_ranks)} local shards")
        cards = torch.cuda.device_count()
        for d in self.devices:
            require(d.type != "cuda" or (d.index or 0) < cards,
                    GDFStatus.GDF_CUDA_ERROR,
                    f"no card {d} on this node ({cards} cards)")

    def new_comm(self):
        """A communicator for one shard-local run over this mesh."""
        if self.backend == "threads":
            return ThreadComm(self.size, self.exchange, self.devices)
        return ProcessGroupComm(self.exchange, self.devices,
                                self.local_ranks[0])

    def shard_streams(self) -> list:
        """One CUDA stream per local shard on a card (None for a shard on
        the CPU), made at the first call and kept: the stream that runs
        the shard's kernels in every shard-local run."""
        if not self._streams:
            self._streams.update(
                (i, torch.cuda.Stream(d) if d.type == "cuda" else None)
                for i, d in enumerate(self.devices))
        return [self._streams[i] for i in range(len(self.devices))]


def _device(device) -> torch.device:
    """host_data_device, with the card's index made explicit (each shard's
    thread selects it)."""
    dev = host_data_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def placement(num_devices: int | None, num_cards: int) -> tuple:
    """The devices of an in-process mesh on a node of `num_cards` cards:
    shard s on cuda:(s % num_cards). `num_devices` None is
    IN_PROCESS_SHARDS shards on a node of one card, else one shard per
    card."""
    require(num_cards >= 1, GDFStatus.GDF_CUDA_ERROR, "no card")
    size = num_devices if num_devices is not None else \
        IN_PROCESS_SHARDS if num_cards == 1 else num_cards
    require(size >= 1, GDFStatus.GDF_INVALID_API_CALL, "a mesh of no shard")
    return tuple(torch.device("cuda", s % num_cards) for s in range(size))


def _card_id(device: torch.device) -> tuple:
    """(host name, card UUID) of a card: the same card in two processes,
    whatever cards each of them sees."""
    return (socket.gethostname(),
            str(torch.cuda.get_device_properties(device).uuid))


def _require_own_leader_cards(dist, leader: torch.device) -> None:
    """Every process raises unless each process's local shard 0, the one
    that calls the group, has a card of its own: NCCL takes one rank a
    card, and two on one card fail inside NCCL. A collective of the
    group's CPU half (an object all-gather)."""
    ids = [None] * dist.get_world_size()
    dist.all_gather_object(ids, _card_id(leader))
    shared = sorted({r for r, i in enumerate(ids) if ids.count(i) > 1})
    require(not shared, GDFStatus.GDF_INVALID_API_CALL,
            f"the local shard 0 of processes {shared} share a card "
            f"(NCCL takes one process a card): give each process a card of "
            f"its own for its first shard")


def _process_group():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def make_mesh(num_devices: int | None = None,
              axis_name: str = DEFAULT_AXIS, device=None) -> Mesh:
    """A mesh of `num_devices` row shards. (`axis_name` stays for the JAX
    package's signature: each shard-local run names its axis itself.)

    With a torch.distributed group of W processes initialized, the mesh
    spans every process, as the JAX package's spans jax.devices() after
    init_distributed: `num_devices` None is one shard per process, else
    `num_devices` = W x L shards, L in each process (W must divide it);
    global shard s = rank * L + i, local shard i on `device` where it is
    given, else on cuda:(s % C), C being the cards this process sees.
    Only local shard 0 calls the group (on its card, under NCCL, which
    takes one rank a card), so no two processes' local shard 0 may share
    a card: on cards, every process raises GDF_INVALID_API_CALL where two
    do (the processes' cards are gathered over the group, so every
    process calls make_mesh). Otherwise every shard in this process: all `num_devices`
    (default IN_PROCESS_SHARDS) on `device` where it is given, else spread
    over the node's cards by `placement` (make_mesh() is one shard per
    card on a node of several). Raises without CUDA unless device="cpu"
    is passed."""
    dist = _process_group()
    if dist is not None:
        procs, rank = dist.get_world_size(), dist.get_rank()
        size = procs if num_devices is None else int(num_devices)
        require(size >= 1 and size % procs == 0,
                GDFStatus.GDF_INVALID_API_CALL,
                f"{size} shards do not split over {procs} processes")
        per = size // procs
        local = tuple(range(rank * per, (rank + 1) * per))
        if device is None:
            host_data_device(None)              # raises without CUDA
            cards = torch.cuda.device_count()
            devices = tuple(torch.device("cuda", s % cards) for s in local)
        else:
            devices = (_device(device),) * len(local)
        if procs > 1 and devices[0].type == "cuda":
            _require_own_leader_cards(dist, devices[0])
        return Mesh(size, devices[0], "process_group", local, devices)
    if device is None:
        host_data_device(None)                  # raises without CUDA
        devices = placement(num_devices, torch.cuda.device_count())
    else:
        size = IN_PROCESS_SHARDS if num_devices is None else int(num_devices)
        require(size >= 1, GDFStatus.GDF_INVALID_API_CALL,
                "a mesh of no shard")
        devices = (_device(device),) * size
    return Mesh(len(devices), devices[0], "threads",
                tuple(range(len(devices))), devices)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Join a torch.distributed group of `num_processes` processes at
    `coordinator` ("host:port"), as rank `process_id`: gloo for CPU
    tensors, NCCL for CUDA tensors where there is a card. A collective
    that waits longer than comm.COLLECTIVE_TIMEOUT (a peer that failed)
    raises. No-op when single process."""
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist
    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))


@dataclass(frozen=True)
class RowSharding:
    """How a row axis splits over a mesh: shard s holds rows
    [s * n / P, (s + 1) * n / P); this process holds `local_ranks`."""

    num_shards: int
    local_ranks: tuple
    device: torch.device

    def local_rows(self, n: int) -> list:
        """The slices of a length-n row axis that this process holds, one
        per local shard (n divisible by the shard count)."""
        require(n % self.num_shards == 0, GDFStatus.GDF_COLUMN_SIZE_MISMATCH,
                f"{n} rows do not split into {self.num_shards} shards; "
                f"pad first")
        per = n // self.num_shards
        return [slice(s * per, (s + 1) * per) for s in self.local_ranks]


def row_sharding(mesh: Mesh, axis_name: str = DEFAULT_AXIS) -> RowSharding:
    """The RowSharding of `mesh`: its shard count, the shards this process
    holds and its home device (the JAX package returns a NamedSharding;
    shard_table places each slab on its shard's own device)."""
    return RowSharding(mesh.size, mesh.local_ranks, mesh.device)


def shard_table(table, mesh: Mesh, axis_name: str = DEFAULT_AXIS) -> tuple:
    """The slabs of a host-global Table that this process holds, one Table
    per local shard, slab i on mesh.devices[i] (the JAX package returns
    one Table of row-sharded arrays). Row count must be divisible by the
    mesh size; pad first if not."""
    sharding = row_sharding(mesh, axis_name)
    out = []
    for rows, dev in zip(sharding.local_rows(table.capacity), mesh.devices):
        cols = tuple(replace(c, data=c.data[rows].to(dev),
                             valid=None if c.valid is None
                             else c.valid[rows].to(dev))
                     for c in table.columns)
        out.append(replace(table, columns=cols, num_rows=None))
    return tuple(out)
