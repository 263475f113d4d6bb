"""The mesh of row shards.

Counterpart of `libgdf_tpu/parallel/mesh.py`, whose mesh is a 1-D
`jax.sharding.Mesh` of devices. Here a mesh is P row shards with one of
two backends (parallel/comm.py):

  threads        every shard in this process, one thread per shard in a
                 shard-local body, all on one device: P shards on one
                 H100, as the JAX tests put 8 virtual devices on one CPU;
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
    of them under `threads`, its own rank under `process_group`), all on
    `device`. `exchange` sums the host time spent in collectives."""

    size: int
    device: torch.device
    backend: str
    local_ranks: tuple
    exchange: ExchangeStats = field(default_factory=ExchangeStats,
                                    compare=False, repr=False)

    def new_comm(self):
        """A communicator for one shard-local run over this mesh."""
        if self.backend == "threads":
            return ThreadComm(self.size, self.exchange)
        return ProcessGroupComm(self.device, self.exchange)


def _device(device) -> torch.device:
    """host_data_device, with the card's index made explicit (each shard's
    thread selects it)."""
    dev = host_data_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


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
    this process (default IN_PROCESS_SHARDS) on `device`, by default the
    card. Raises without CUDA unless device="cpu" is passed."""
    dist = _process_group()
    if dist is not None:
        size = dist.get_world_size()
        require(num_devices in (None, size), GDFStatus.GDF_INVALID_API_CALL,
                f"a process group of {size} ranks holds {size} shards")
        rank = dist.get_rank()
        if device is None and torch.cuda.is_available():
            device = torch.device("cuda", rank % torch.cuda.device_count())
        return Mesh(size, _device(device), "process_group", (rank,))
    size = IN_PROCESS_SHARDS if num_devices is None else int(num_devices)
    require(size >= 1, GDFStatus.GDF_INVALID_API_CALL, "a mesh of no shard")
    return Mesh(size, _device(device), "threads", tuple(range(size)))


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
    holds and their device (the JAX package returns a NamedSharding)."""
    return RowSharding(mesh.size, mesh.local_ranks, mesh.device)


def shard_table(table, mesh: Mesh, axis_name: str = DEFAULT_AXIS) -> tuple:
    """The slabs of a host-global Table that this process holds, one Table
    per local shard on the mesh's device (the JAX package returns one
    Table of row-sharded arrays). Row count must be divisible by the mesh
    size; pad first if not."""
    sharding = row_sharding(mesh, axis_name)
    out = []
    for rows in sharding.local_rows(table.capacity):
        cols = tuple(replace(c, data=c.data[rows].to(sharding.device),
                             valid=None if c.valid is None
                             else c.valid[rows].to(sharding.device))
                     for c in table.columns)
        out.append(replace(table, columns=cols, num_rows=None))
    return tuple(out)
