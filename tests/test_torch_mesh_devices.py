"""The distributed layer's devices, on the CPU: where make_mesh puts each
shard, where shard_table puts each slab, and that counts and collected rows
come back to the mesh's home device.

The rule of make_mesh on a node of C cards (shard s on cuda:(s % C)) is
`libgdf_tpu_torch.parallel.mesh.placement`, which takes the card count as
its argument, so it is checked here for 1, 2 and 4 cards without one.
Where a test needs shards on two devices, it builds the Mesh with an
explicit device list over the two devices this machine has: the CPU and
`meta` (shapes, no data). A copy out of `meta` raises NotImplementedError,
and a concatenation across devices RuntimeError, which is how the collect
test tells a slab copied home from one left where it was. The pipeline on
the communicator with per-rank devices is held to libgdf_tpu shard by
shard at P = 8, as tests/test_torch_parallel.py holds each operator
(integers and counts exact, float64 sums to rtol 1e-12, atol 1e-12).
"""
import numpy as np
import pytest
import torch

import libgdf_tpu
from libgdf_tpu import ops as jops
from libgdf_tpu import parallel as jpar
from libgdf_tpu_torch import GDFError, GDFStatus, Table, ops
from libgdf_tpu_torch import parallel as par
from libgdf_tpu_torch.parallel import comm
from libgdf_tpu_torch.parallel.distributed import (SaltedJoinPlan,
                                                   _assemble, _spmd)
from libgdf_tpu_torch.parallel.mesh import IN_PROCESS_SHARDS, Mesh, placement

from test_torch_parallel import assert_sharded_match

CPU, META = torch.device("cpu"), torch.device("meta")


def mesh_on(devices):
    """An in-process mesh with shard s on devices[s]; home devices[0]."""
    devices = tuple(torch.device(d) for d in devices)
    return Mesh(len(devices), devices[0], "threads",
                tuple(range(len(devices))), devices)


# -- placement ---------------------------------------------------------------

@pytest.mark.parametrize("num_devices,num_cards,want", [
    (None, 1, [0] * IN_PROCESS_SHARDS),
    (None, 2, [0, 1]),
    (None, 4, [0, 1, 2, 3]),
    (4, 4, [0, 1, 2, 3]),
    (8, 4, [0, 1, 2, 3, 0, 1, 2, 3]),
    (5, 2, [0, 1, 0, 1, 0]),
    (3, 1, [0, 0, 0]),
])
def test_placement_puts_shard_s_on_card_s_mod_c(num_devices, num_cards,
                                                 want):
    assert placement(num_devices, num_cards) == tuple(
        torch.device("cuda", i) for i in want)


@pytest.mark.parametrize("num_devices,num_cards,status", [
    (None, 0, "GDF_CUDA_ERROR"), (4, 0, "GDF_CUDA_ERROR"),
    (0, 2, "GDF_INVALID_API_CALL")])
def test_placement_refuses_no_card_and_no_shard(num_devices, num_cards,
                                                status):
    with pytest.raises(GDFError) as err:
        placement(num_devices, num_cards)
    assert err.value.status == getattr(GDFStatus, status)


@pytest.mark.parametrize("size", [1, 3, IN_PROCESS_SHARDS])
def test_make_mesh_on_a_given_device_keeps_every_shard_there(size):
    mesh = par.make_mesh(size, device="cpu")
    assert (mesh.size, mesh.backend, mesh.device) == (size, "threads", CPU)
    assert mesh.devices == (CPU,) * size
    assert mesh.local_ranks == tuple(range(size))
    assert mesh.shard_streams() == [None] * size
    assert par.make_mesh(device="cpu").devices == (CPU,) * IN_PROCESS_SHARDS


@pytest.mark.parametrize("num_devices", [None, 1, 4])
def test_make_mesh_without_cuda_raises(num_devices):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: make_mesh() places shards "
                    "on it")
    with pytest.raises(GDFError) as err:
        par.make_mesh(num_devices)
    assert err.value.status == GDFStatus.GDF_CUDA_ERROR


def test_a_shard_on_a_missing_card_raises():
    missing = torch.device("cuda", torch.cuda.device_count())
    with pytest.raises(GDFError) as err:
        mesh_on([CPU, missing])
    assert err.value.status == GDFStatus.GDF_CUDA_ERROR
    with pytest.raises(GDFError):
        Mesh(2, CPU, "threads", (0, 1), (CPU,))   # a device per shard


# -- slabs and counts ---------------------------------------------------------

def _table(n, device="cpu"):
    rng = np.random.default_rng(n)
    return Table.from_dict({"k": np.arange(n, dtype=np.int64),
                            "v": rng.standard_normal(n)},
                           {"v": rng.random(n) < 0.3}, device=device)


def test_shard_table_puts_slab_s_on_devices_s():
    devices = [CPU, META, CPU, META]
    mesh = mesh_on(devices)
    slabs = par.shard_table(_table(16), mesh)
    for slab, dev in zip(slabs, devices):
        assert slab.capacity == 4
        assert {c.data.device for c in slab.columns} == {dev}
        assert {c.valid.device for c in slab.columns
                if c.valid is not None} == {dev}
    for s in (0, 2):
        assert slabs[s]["k"].data.tolist() == list(range(4 * s, 4 * s + 4))
    st = par.distribute(_table(15), mesh)          # padded to 16
    assert st.counts.device == CPU and st.counts.tolist() == [4, 4, 4, 3]
    assert [s.device for s in st.shards] == devices


def test_assemble_takes_the_counts_home():
    outs = [_table(6).with_num_rows(n) for n in (5, 2)]
    st = _assemble(mesh_on([META, CPU]), outs, [0, 0])
    assert st.counts.device == META and st.counts.shape == (2,)
    assert [s.device for s in st.shards] == [CPU, CPU]
    assert all(s.num_rows is None for s in st.shards)
    st = _assemble(mesh_on([CPU, CPU]), outs, [0, 1])
    assert st.counts.tolist() == [5, 2] and st.overflow.tolist() == [0, 1]


def test_collect_copies_every_slab_home():
    t = _table(8)
    home = par.ShardedTable(shards=(t, t), counts=torch.tensor(
        [3, 5], dtype=torch.int32))
    got = par.collect(home)
    assert got.device == CPU
    assert got["k"].data.tolist() == [0, 1, 2, 0, 1, 2, 3, 4]
    assert home.table.capacity == 16
    away = par.ShardedTable(shards=(t, t.to(META)), counts=home.counts)
    # the meta slab is copied to the CPU (and a copy out of meta raises),
    # not concatenated where it lies (which would raise RuntimeError)
    with pytest.raises(NotImplementedError, match="meta"):
        par.collect(away)
    with pytest.raises(NotImplementedError, match="meta"):
        away.table


def test_salted_plan_keeps_a_hot_table_on_every_device():
    mesh = mesh_on([CPU, META, CPU])
    hot = np.arange(64) % 5 == 0
    plan = SaltedJoinPlan(mesh, ["k"], ["k"], "inner", hot, 1, 1, 1, 64,
                          par.DEFAULT_AXIS)
    assert set(plan._hot) == {CPU, META}
    assert plan.hot.device == CPU
    np.testing.assert_array_equal(plan.hot.numpy(), hot)


# -- the communicator with a device per rank ----------------------------------

def test_thread_comm_collectives_per_rank():
    mesh = mesh_on([CPU] * 3)
    ax = par.DEFAULT_AXIS

    def body(i, rank):
        x = torch.tensor([rank, 10 - rank], dtype=torch.int64)
        # rank p sends p + 1 copies of 10 p + q to rank q
        chunks = [torch.full((rank + 1,), 10 * rank + q, dtype=torch.int64)
                  for q in range(3)]
        recv = comm.all_to_all_ints([c.shape[0] for c in chunks], ax)
        out = torch.zeros(9, dtype=torch.int64)
        a2a = comm.all_to_all(chunks, recv, out, ax)
        return (comm.psum(x, ax).tolist(), comm.pmax(x, ax).tolist(),
                [g.tolist() for g in comm.all_gather(x, ax)],
                a2a.tolist(), comm.psum(rank, ax), comm.pmax(rank, ax),
                comm.all_gather_ints(rank * 2, ax))

    for rank, got in enumerate(_spmd(mesh, ax, body)):
        assert got[0] == [3, 27] and got[1] == [2, 10]
        assert got[2] == [[0, 10], [1, 9], [2, 8]]
        assert got[3] == [rank] + [10 + rank] * 2 + [20 + rank] * 3
        assert got[4:] == (3, 2, [0, 2, 4])


# -- the pipeline against libgdf_tpu ------------------------------------------

def test_pipeline_equals_the_jax_package_shard_by_shard():
    """filter -> shuffle join -> groupby at P = 8 on a mesh given its
    device list, against the JAX package on its 8 virtual devices."""
    rng = np.random.default_rng(21)
    n, nkeys = 3000, 200
    fact = {"k": (rng.zipf(1.3, n) % nkeys).astype(np.int64),
            "v": rng.standard_normal(n)}
    dim = {"k": np.arange(nkeys, dtype=np.int64),
           "w": rng.standard_normal(nkeys)}
    nulls = {"v": rng.random(n) < 0.1}
    aggs = [("v", "sum", "s"), ("v", "count", "c"), ("w", "max", "m")]

    jm = jpar.make_mesh()
    jf = jpar.distribute(libgdf_tpu.Table.from_dict(fact, nulls=nulls), jm)
    jd = jpar.distribute(libgdf_tpu.Table.from_dict(dim), jm)
    jf = jpar.map_shards(jm, lambda t: jops.filter_table(
        t, jops.compare_scalar(t["v"], -0.5, "gt")), jf)
    jj = jpar.dist_join(jm, jf, jd, ["k"], ["k"])
    jout = jpar.dist_groupby(jm, jj, ["k"], aggs)

    mesh = mesh_on([CPU] * 8)
    tf = par.distribute(Table.from_dict(fact, nulls, device="cpu"), mesh)
    td = par.distribute(Table.from_dict(dim, device="cpu"), mesh)
    tf = par.map_shards(mesh, lambda t: ops.filter_table(
        t, ops.compare_scalar(t["v"], -0.5, "gt")), tf)
    tj = par.dist_join(mesh, tf, td, ["k"], ["k"])
    assert_sharded_match(jj, tj)
    out = par.dist_groupby(mesh, tj, ["k"], aggs)
    assert_sharded_match(jout, out, {"s": (1e-12, 1e-12)})
    assert out.counts.device == CPU
