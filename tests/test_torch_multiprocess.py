"""The port's distributed layer across processes: 2 torch.distributed
processes on gloo, one shard each, run tests/torch_mp_worker.py
(distribute_global -> dist_groupby, and three joins, checked by
all-reduced sums against a numpy oracle). The port's form of
tests/test_multiprocess.py.

Then a mesh of 2 processes x L shards (the worker's second form): at
L = 1 over int16 keys and values, which gloo cannot carry (fault C9), and
at L = 4, the JAX package's own layout (tests/mp_worker.py), every shard
of every operator held bit for bit to an in-process mesh of 2 L shards,
and to libgdf_tpu on its 8 virtual CPU devices (float64 sums to rtol
1e-12, atol 1e-12)."""
import numpy as np
import pytest

import libgdf_tpu
from libgdf_tpu import parallel as jpar
from libgdf_tpu_torch import Table
from libgdf_tpu_torch import parallel as par

import torch_mp_worker as mpw
from test_torch_parallel import F64_SUM, _torch_shards, assert_sharded_match


def test_two_process_dist_groupby():
    mpw.run_workers(2)


# -- a mesh of W processes x L shards (tests/torch_mp_worker.py, second form)

PROCS = 2


@pytest.fixture(scope="module")
def jax_ops():
    """The operators of torch_mp_worker.run_ops in libgdf_tpu, on its 8
    virtual CPU devices (tests/conftest.py)."""
    fact, nulls, dim = mpw.mixed_data()
    jm = jpar.make_mesh()
    jf = jpar.distribute(libgdf_tpu.Table.from_dict(fact, nulls=nulls), jm)
    jd = jpar.distribute(libgdf_tpu.Table.from_dict(dim), jm)
    return {
        "groupby_k": jpar.dist_groupby(jm, jf, ["k"], mpw.GROUPBY_K),
        "groupby_h": jpar.dist_groupby(jm, jf, ["h"], mpw.GROUPBY_H),
        "join": jpar.dist_join(jm, jf, jd, ["k"], ["k"],
                               out_capacity_per_shard=jf.capacity),
        "broadcast": jpar.broadcast_join(jm, jf, jd, ["k"], ["k"]),
        "salted": jpar.dist_join_salted(jm, jf, jd, ["k"], ["k"],
                                        num_bins=64, threshold=3.0),
    }


def _rows(t):
    """A compacted table's rows as sorted tuples (value, or None where
    null), for comparing tables whose row order differs."""
    cols = [c.to_numpy_masked() for c in t.compact().columns]
    return sorted(zip(*[[None if n else v.item() for v, n in zip(*c)]
                        for c in cols]),
                  key=lambda r: tuple((x is None, x or 0) for x in r))


def assert_same_shards(got, want, what):
    """Capacity, per-shard counts, and each shard's live rows: names,
    dtypes, null masks and values, bit for bit."""
    assert got.capacity == want.capacity, what
    assert got.counts.tolist() == want.counts.tolist(), what
    for s, (g, w) in enumerate(zip(_torch_shards(got), _torch_shards(want))):
        assert list(g) == list(w), (what, s)
        for name, ((gv, gn), (wv, wn)) in zip(w, zip(g.values(),
                                                     w.values())):
            assert gv.dtype == wv.dtype, (what, s, name)
            np.testing.assert_array_equal(gn, wn, err_msg=f"{what} {s}")
            np.testing.assert_array_equal(gv.view(np.uint8),
                                          wv.view(np.uint8),
                                          err_msg=f"{what} {s}.{name}")


def _in_process(size: int) -> dict:
    fact, nulls, dim = mpw.mixed_data()
    mesh = par.make_mesh(size, device="cpu")
    return mpw.run_ops(
        mesh, par.distribute(Table.from_dict(fact, nulls, device="cpu"),
                             mesh),
        par.distribute(Table.from_dict(dim, device="cpu"), mesh))


@pytest.mark.parametrize("local_shards", [1, 4])
def test_processes_equal_an_in_process_mesh_and_the_jax_package(
        local_shards, jax_ops, tmp_path):
    """2 gloo processes x L shards, make_mesh(2 L), over int16 keys and
    values (which gloo cannot carry: they cross as their bytes) and float64
    values with nulls. Every shard of every operator equals, bit for bit,
    the same shard of an in-process mesh of 2 L shards; at 2 x 4, the JAX
    package's own layout (tests/mp_worker.py), every shard also equals
    libgdf_tpu's on its 8 devices, and at 2 x 1 the collected rows do."""
    size = PROCS * local_shards
    mpw.run_workers(PROCS, "--local-shards", str(local_shards),
                    "--out", str(tmp_path))
    want = _in_process(size)
    for op in mpw.OPS:
        got = mpw.load_shards(str(tmp_path), op, size)
        assert_same_shards(got, want[op], op)
        if size == 8:
            assert_sharded_match(jax_ops[op], got, {"vs": F64_SUM})
        else:
            assert _rows(par.collect(got)) == _rows(
                jpar.collect(jax_ops[op]))
