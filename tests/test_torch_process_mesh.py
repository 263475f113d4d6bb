"""The mesh that spans processes, on the CPU, without a second process.

make_mesh under a group of W processes is checked against a stub group
(world size and rank only), with the card count patched: the default of
one shard a process, global shard s = rank * L + i on cuda:(s % C), the
refusal of a shard count W does not divide, and of a layout in which two
processes' local shard 0 (the one that calls NCCL) share a card.

The communicator of such a mesh (parallel/comm.py::ProcessGroupComm) is
held to the in-process one (ThreadComm) in a real one-rank gloo group
with 4 local shards: every collective, over every column dtype of
core/dtypes.py and bool, gives every rank the same bytes. Gloo has no
int16 (fault C9: it raised "Invalid scalar type"), so that dtype is the
proof that tensors cross as their bytes. The group sees one call a
collective, made by local shard 0's thread.
"""
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from libgdf_tpu_torch import GDFError, GDFStatus
from libgdf_tpu_torch import parallel as par
from libgdf_tpu_torch.core.dtypes import _PHYSICAL
from libgdf_tpu_torch.parallel import comm, mesh as mesh_mod
from libgdf_tpu_torch.parallel.comm import ProcessGroupComm, ThreadComm
from libgdf_tpu_torch.parallel.distributed import _spmd
from libgdf_tpu_torch.parallel.mesh import Mesh

CPU = torch.device("cpu")
LOCAL = 4
DTYPES = sorted(set(_PHYSICAL.values()), key=str) + [torch.bool]


class _StubGroup:
    """World size and rank; all_gather_object hands back this process's
    object and, for each other rank r, peers[r] (by default a card on a
    host of its own)."""

    def __init__(self, size, rank, peers=None):
        self.size, self.rank = size, rank
        self.peers = peers or {r: (f"host-{r}", "card-0")
                               for r in range(size)}

    def all_gather_object(self, out, obj):
        for r in range(self.size):
            out[r] = obj if r == self.rank else self.peers[r]

    def get_world_size(self):
        return self.size

    def get_rank(self):
        return self.rank


@pytest.fixture
def stub_group(monkeypatch):
    """make_mesh sees a group of `size` processes, as `rank`, on a node of
    `cards` cards (this process's card i is ("node", "card-i")), the
    other processes' local shard 0 on the cards `peers` gives."""
    def use(size, rank, cards=4, peers=None):
        monkeypatch.setattr(mesh_mod, "_process_group",
                            lambda: _StubGroup(size, rank, peers))
        monkeypatch.setattr(mesh_mod, "_card_id",
                            lambda d: ("node", f"card-{d.index}"))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    return use


@pytest.mark.parametrize("procs,rank,cards,want", [
    (2, 0, 4, [0]), (2, 1, 4, [1]), (4, 3, 4, [3]), (3, 2, 2, [0]),
])
def test_make_mesh_default_is_one_shard_a_process(stub_group, procs, rank,
                                                  cards, want):
    stub_group(procs, rank, cards)
    m = par.make_mesh()
    assert (m.size, m.backend, m.local_ranks) == (procs, "process_group",
                                                  (rank,))
    assert m.devices == tuple(torch.device("cuda", i) for i in want)
    assert m.device == m.devices[0]
    stub_group(procs, rank, cards)
    assert par.make_mesh(device="cpu").devices == (CPU,)


@pytest.mark.parametrize("procs,rank,num,cards,want", [
    (2, 0, 8, 4, [0, 1, 2, 3]),        # the JAX package's 2 x 4 layout
    (2, 1, 8, 4, [0, 1, 2, 3]),
    (2, 1, 4, 4, [2, 3]),              # 2 processes on 4 cards, 2 each
    (4, 2, 4, 4, [2]),                 # a process a card
    (1, 0, 8, 1, [0] * 8),             # one process, 8 shards on one card
    (3, 1, 6, 2, [0, 1]),
])
def test_make_mesh_numbers_shards_process_by_process(stub_group, procs, rank,
                                                     num, cards, want):
    stub_group(procs, rank, cards)
    m = par.make_mesh(num)
    local = num // procs
    assert (m.size, m.backend) == (num, "process_group")
    assert m.local_ranks == tuple(range(rank * local, (rank + 1) * local))
    assert m.devices == tuple(torch.device("cuda", i) for i in want)
    assert m.device == m.devices[0]
    rs = par.row_sharding(m)
    assert rs.local_rows(num * 3) == [slice(3 * s, 3 * s + 3)
                                      for s in m.local_ranks]
    stub_group(procs, rank, cards)
    m = par.make_mesh(num, device="cpu")
    assert m.devices == (CPU,) * local and m.size == num


@pytest.mark.parametrize("procs,num", [(2, 3), (4, 6), (3, 0), (2, -2)])
def test_make_mesh_refuses_a_count_the_processes_do_not_divide(
        stub_group, procs, num):
    stub_group(procs, 0)
    with pytest.raises(GDFError) as e:
        par.make_mesh(num, device="cpu")
    assert e.value.status == GDFStatus.GDF_INVALID_API_CALL


@pytest.mark.parametrize("procs,num,cards,shared", [
    (2, 8, 4, True),     # the JAX package's 2 x 4 on one node of 4 cards
    (2, 4, 2, True),
    (3, 3, 2, True),     # processes 0 and 2 on cuda:0; all three raise
    (2, 4, 4, False),    # local shard 0 on cuda:0 and cuda:2
    (4, 4, 4, False),    # a process a card
])
def test_make_mesh_refuses_two_processes_leading_from_one_card(
        stub_group, procs, num, cards, shared):
    """Every process of one node gets its peers' local shard 0 cards, as
    their make_mesh places them; where two share a card every process
    raises (NCCL would fail inside), else the mesh is made."""
    local = num // procs
    peers = {r: ("node", f"card-{r * local % cards}") for r in range(procs)}
    for rank in range(procs):
        stub_group(procs, rank, cards, peers)
        if shared:
            with pytest.raises(GDFError) as e:
                par.make_mesh(num)
            assert e.value.status == GDFStatus.GDF_INVALID_API_CALL
        else:
            assert par.make_mesh(num).device == torch.device(
                "cuda", rank * local % cards)
        # on the CPU no shard calls NCCL
        stub_group(procs, rank, cards, peers)
        assert par.make_mesh(num, device="cpu").devices == (CPU,) * local


# -- the communicator in a one-rank gloo group --------------------------------

@pytest.fixture
def group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _values(dtype, rank, n, salt, device):
    """n values of `dtype` for `rank`, over the dtype's range (int16 sums
    wrap)."""
    rng = np.random.default_rng(1000 * rank + n + salt)
    if dtype == torch.bool:
        x = rng.random(n) < 0.5
    elif dtype.is_floating_point:
        x = rng.standard_normal(n)
    else:
        info = torch.iinfo(dtype)
        x = rng.integers(info.min, info.max, n, endpoint=True)
    return torch.as_tensor(x, device=device).to(dtype)


def collectives(i, rank):
    """Every collective over every dtype, on the rank's device (that of
    a tensor the mesh's shards hold); a list of what this rank got, on
    the host."""
    ax = par.DEFAULT_AXIS
    dev = comm.current(ax)[0].devices[i]
    out = [comm.axis_size(ax), comm.axis_index(ax),
           comm.all_gather_ints(3 * rank - 1, ax),
           comm.psum(rank + 1, ax), comm.pmax(-rank, ax)]
    for dtype in DTYPES:
        for sizes in ([(rank + q) % 3 for q in range(LOCAL)], [0] * LOCAL):
            chunks = [_values(dtype, rank, k, q, dev)
                      for q, k in enumerate(sizes)]
            recv = comm.all_to_all_ints(sizes, ax)
            buf = torch.zeros(sum(recv) + 2, dtype=dtype, device=dev)
            out += [recv, comm.all_to_all(chunks, recv, buf, ax).clone()]
        x = _values(dtype, rank, 5, 0, dev)
        out += comm.all_gather(x, ax)
        out += [comm.all_gather(x[:0], ax)[rank]]
        out += [comm.psum(x, ax), comm.pmax(x, ax),
                comm.pmax(x[2], ax)]
    return [o.cpu() if isinstance(o, torch.Tensor) else o for o in out]


def same_bytes(got, want):
    """Two ranks' lists of collectives' results: ints equal, tensors of
    one dtype and shape and the same bytes."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g.reshape(-1).view(torch.uint8),
                               w.reshape(-1).view(torch.uint8)), \
                (g, w)
        else:
            assert g == w


def test_process_comm_equals_thread_comm_for_every_dtype(group):
    threads = Mesh(LOCAL, CPU, "threads", tuple(range(LOCAL)))
    want = _spmd(threads, par.DEFAULT_AXIS, collectives)
    m = par.make_mesh(LOCAL, device="cpu")
    assert (m.backend, m.local_ranks) == ("process_group", (0, 1, 2, 3))
    assert isinstance(m.new_comm(), ProcessGroupComm)
    assert isinstance(threads.new_comm(), ThreadComm)
    got = _spmd(m, par.DEFAULT_AXIS, collectives)
    for g, w in zip(got, want):
        same_bytes(g, w)


def test_only_local_shard_0_calls_the_group(group, monkeypatch):
    calls = []
    for name in ("all_gather", "all_to_all_single"):
        fn = getattr(dist, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls.append((_name, threading.current_thread().name))
            return _fn(*a, **kw)
        monkeypatch.setattr(dist, name, counted)
    ax = par.DEFAULT_AXIS

    def body(i, rank):
        x = torch.full((3,), rank, dtype=torch.int16)
        recv = comm.all_to_all_ints([1] * LOCAL, ax)
        comm.all_to_all([x[:1]] * LOCAL, recv,
                        torch.empty(LOCAL, dtype=x.dtype), ax)
        comm.all_gather(x, ax)
        return comm.psum(x, ax)

    got = _spmd(par.make_mesh(LOCAL, device="cpu"), ax, body)
    assert [g.tolist() for g in got] == [[6, 6, 6]] * LOCAL
    assert calls == [("all_gather", "shard-0"), ("all_to_all_single",
                                                 "shard-0"),
                     ("all_gather", "shard-0"), ("all_gather", "shard-0")]


class _Boom(Exception):
    pass


@pytest.mark.parametrize("who", [0, 2])
def test_a_rank_that_raises_is_raised_with_its_type(group, who):
    """The leader (local shard 0) or another shard raises before a
    collective; the others, waiting in it, are woken and the error comes
    back from the caller with its type."""
    def body(i, rank):
        if rank == who:
            raise _Boom(rank)
        return comm.psum(torch.ones(2), par.DEFAULT_AXIS)

    with pytest.raises(_Boom):
        _spmd(par.make_mesh(LOCAL, device="cpu"), par.DEFAULT_AXIS, body)
