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
  process_group  one shard per process of an initialized torch.distributed
                 group (init_distributed), each on its own device.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch

from ..core.column import host_data_device
from ..core.errors import GDFStatus, require
from .comm import ExchangeStats, ProcessGroupComm, ThreadComm

DEFAULT_AXIS = "shards"
# Shards of an in-process mesh unless the caller says: the JAX tests' 8
# virtual devices (tests/conftest.py).
IN_PROCESS_SHARDS = 8


@dataclass(frozen=True)
class Mesh:
    """P row shards. `local_ranks` are the shards this process holds (all
    of them under `threads`, its own rank under `process_group`);
    `devices` holds one device per local shard (by default `device` for
    each). `device` is the home device: shard 0's, or this process's
    rank's, where the live counts of a ShardedTable and what collect()
    returns live. `exchange` sums the host time spent in collectives.
    Raises if a device is a card this node does not have."""

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
        return ProcessGroupComm(self.device, self.exchange)

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


def _process_group():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def make_mesh(num_devices: int | None = None,
              axis_name: str = DEFAULT_AXIS, device=None) -> Mesh:
    """A mesh of `num_devices` row shards. (`axis_name` stays for the JAX
    package's signature: each shard-local run names its axis itself.)

    With a torch.distributed group initialized: one shard per rank (the
    group's size; `num_devices` must be None or equal it), on `device` or
    else the card of index rank % device count. Otherwise every shard in
    this process: all `num_devices` (default IN_PROCESS_SHARDS) on
    `device` where it is given, else spread over the node's cards by
    `placement` (make_mesh() is one shard per card on a node of several).
    Raises without CUDA unless device="cpu" is passed."""
    dist = _process_group()
    if dist is not None:
        size = dist.get_world_size()
        require(num_devices in (None, size), GDFStatus.GDF_INVALID_API_CALL,
                f"a process group of {size} ranks holds {size} shards")
        rank = dist.get_rank()
        if device is None and torch.cuda.is_available():
            device = torch.device("cuda", rank % torch.cuda.device_count())
        return Mesh(size, _device(device), "process_group", (rank,))
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
    tensors, NCCL for CUDA tensors where there is a card. No-op when
    single process."""
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist
    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


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
