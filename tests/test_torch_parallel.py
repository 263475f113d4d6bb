"""libgdf_tpu_torch.parallel against libgdf_tpu.parallel at P = 8, on the CPU.

The same numpy tables go through both packages: the JAX side on the 8
virtual CPU devices of tests/conftest.py, the port on 8 in-process shards
(one thread each). Results are compared shard by shard: the per-shard live
counts and the global capacity exactly, and for every shard its live rows
in order, which pins the placement (Murmur3 % P, plus the salt) and the
row order inside a shard after a shuffle (source shard, then source row).
Null masks, integers and counts are exact; float64 sums and averages are
held to rtol 1e-12, atol 1e-12 (the segmented scans add in another order);
errors match by type and status. One case per test of
tests/test_parallel.py, plus the port's own cases (a shard left with zero
rows, a rank that raises alone, a collective that times out). Each JAX
result is computed once per module.
"""
import threading

import numpy as np
import pytest

import libgdf_tpu
from libgdf_tpu import ops as jops
from libgdf_tpu import parallel as jpar
from libgdf_tpu.core.errors import GDFError as JGDFError
from libgdf_tpu_torch import GDFError, GDFStatus, Table, ops
from libgdf_tpu_torch import parallel as par
from libgdf_tpu_torch.parallel import comm
from libgdf_tpu_torch.parallel.distributed import distribute_global

P = 8
F64_SUM = (1e-12, 1e-12)


@pytest.fixture(scope="module")
def jmesh():
    return jpar.make_mesh()


@pytest.fixture(scope="module")
def mesh():
    return par.make_mesh(device="cpu")


class _Once:
    """Each JAX result computed on first use, then kept for the module."""

    def __init__(self, mesh):
        self.mesh, self._done = mesh, {}

    def __call__(self, key, fn):
        if key not in self._done:
            self._done[key] = fn(self.mesh)
        return self._done[key]


@pytest.fixture(scope="module")
def ref(jmesh):
    return _Once(jmesh)


def tables(cols, nulls=None):
    """The same data as a libgdf_tpu Table and a libgdf_tpu_torch one."""
    return (libgdf_tpu.Table.from_dict(cols, nulls=nulls),
            Table.from_dict(cols, nulls, device="cpu"))


def _jax_shards(st):
    counts = np.asarray(st.counts)
    per = st.capacity // len(counts)
    out = []
    for s, k in enumerate(counts):
        rows = slice(s * per, s * per + int(k))
        out.append({name: (np.asarray(c.data)[rows],
                           np.zeros(int(k), bool) if c.valid is None
                           else ~np.asarray(c.valid)[rows])
                    for name, c in zip(st.table.names, st.table.columns)})
    return out


def _torch_shards(st):
    counts = st.counts.cpu().numpy()
    return [{name: (c.data[:k].numpy(),
                    np.zeros(int(k), bool) if c.valid is None
                    else ~c.valid[:k].numpy())
             for name, c in zip(slab.names, slab.columns)}
            for slab, k in zip(st.shards, counts)]


def assert_sharded_match(jst, tst, tol=None):
    """Capacity, per-shard counts, and each shard's live rows in order:
    names, dtypes, null masks, and values where valid (exact, or to
    tol = {name: (rtol, atol)})."""
    tol = tol or {}
    assert tst.capacity == jst.capacity
    np.testing.assert_array_equal(tst.counts.cpu().numpy(),
                                  np.asarray(jst.counts))
    for s, (j, t) in enumerate(zip(_jax_shards(jst), _torch_shards(tst))):
        assert list(t) == list(j), s
        for name in j:
            (jv, jn), (tv, tn) = j[name], t[name]
            np.testing.assert_array_equal(tn, jn, err_msg=f"{s}.{name}")
            assert tv.dtype == jv.dtype, (s, name, tv.dtype, jv.dtype)
            if name in tol:
                np.testing.assert_allclose(tv[~jn], jv[~jn], rtol=tol[name][0],
                                           atol=tol[name][1],
                                           err_msg=f"{s}.{name}")
            else:
                np.testing.assert_array_equal(tv[~jn], jv[~jn],
                                              err_msg=f"{s}.{name}")


def assert_collected_match(jt, tt, tol=None):
    tol = tol or {}
    jt, tt = jt.compact(), tt.compact()
    assert tt.names == jt.names and tt.capacity == jt.capacity
    for name in jt.names:
        jv, jn = jt[name].to_numpy_masked()
        tv, tn = tt[name].to_numpy_masked()
        np.testing.assert_array_equal(tn, jn, err_msg=name)
        if name in tol:
            np.testing.assert_allclose(tv[~jn], jv[~jn], *tol[name])
        else:
            np.testing.assert_array_equal(tv[~jn], jv[~jn], err_msg=name)


# -- data (one seed per case, shared by both packages) ------------------------

def roundtrip_data():
    rng = np.random.default_rng(1)
    n = 1001  # not divisible by 8: padding
    return ({"a": rng.integers(0, 100, n).astype(np.int32),
             "b": rng.standard_normal(n)}, {"a": rng.random(n) < 0.2})


def keyed_data(seed=3, n=2048, nkeys=500, null_p=0.2):
    rng = np.random.default_rng(seed)
    return ({"k": rng.integers(0, nkeys, n).astype(np.int64),
             "v": rng.standard_normal(n)}, {"v": rng.random(n) < null_p})


def join_data():
    rng = np.random.default_rng(5)
    nl, nr = 2048, 512
    left = {"k": rng.integers(0, 400, nl).astype(np.int32),
            "lv": rng.standard_normal(nl)}
    right = {"k": rng.integers(200, 600, nr).astype(np.int32),
             "rv": rng.standard_normal(nr)}
    return left, right


def zipf_data(seed, nl, nr, hot_key, p_hot, nkeys, unique_right=True):
    rng = np.random.default_rng(seed)
    left = {"k": np.where(rng.random(nl) < p_hot, hot_key,
                          rng.integers(0, nkeys, nl)).astype(np.int32),
            "lv": rng.standard_normal(nl)}
    rk = np.arange(nr, dtype=np.int32) if unique_right else \
        rng.permutation(1024)[:nr].astype(np.int32)
    right = {"k": rk, "rv": rng.standard_normal(nr)}
    return left, right, rng.random(nl) < 0.1


GB_AGGS = [("v", "sum", "s"), ("v", "count", "n"), ("v", "avg", "m"),
           ("v", "min", "lo"), ("v", "max", "hi")]
GB_TOL = {"s": F64_SUM, "m": F64_SUM}


def _shuffle_body(mod, slot, num_batches=1, overflow=False):
    def body(local):
        return mod.shuffle_shard(local, ["k"], mod.DEFAULT_AXIS,
                                 slot_capacity=slot, num_batches=num_batches,
                                 return_overflow=overflow)
    return body


# -- the layer's surface ------------------------------------------------------

def test_same_names_as_the_jax_package():
    assert par.__all__ == jpar.__all__
    assert "distribute_global" not in par.__all__
    assert par.DEFAULT_AXIS == jpar.DEFAULT_AXIS


def test_make_mesh_defaults(mesh):
    assert (mesh.size, mesh.backend, mesh.device.type) == (P, "threads",
                                                           "cpu")
    assert par.make_mesh(3, device="cpu").size == 3
    rows = par.row_sharding(mesh).local_rows(16)
    assert rows == [slice(2 * s, 2 * s + 2) for s in range(P)]
    _, tt = tables({"k": np.arange(16, dtype=np.int64)})
    slabs = par.shard_table(tt, mesh)
    assert [int(s["k"].data[0]) for s in slabs] == list(range(0, 16, 2))


# -- one case per test of tests/test_parallel.py ------------------------------

def test_distribute_collect_roundtrip(mesh, ref):
    cols, nulls = roundtrip_data()
    jt, tt = tables(cols, nulls)
    jst = ref("roundtrip", lambda m: jpar.distribute(jt, m))
    st = par.distribute(tt, mesh)
    assert_sharded_match(jst, st)
    assert st.table.capacity == jst.table.capacity == 1008
    assert int(st.total_rows()) == int(jst.total_rows()) == 1001
    assert_collected_match(jpar.collect(jst), par.collect(st))
    g = distribute_global(tt, mesh)
    assert_sharded_match(jst, g)


def test_map_shards_filter(mesh, ref):
    rng = np.random.default_rng(2)
    cols = {"a": rng.integers(0, 100, 1024).astype(np.int32)}
    jt, tt = tables(cols)

    def jbody(local):
        return jops.filter_table(local, jops.compare_scalar(local["a"], 50,
                                                            "lt"))

    def tbody(local):
        return ops.filter_table(local, ops.compare_scalar(local["a"], 50,
                                                          "lt"))
    jout = ref("filter", lambda m: jpar.map_shards(
        m, jbody, jpar.distribute(jt, m)))
    assert_sharded_match(jout,
                         par.map_shards(mesh, tbody, par.distribute(tt, mesh)))


def test_shuffle_colocates_keys(mesh, ref):
    """Placement and in-shard row order: each key on the shard its Murmur3
    hash selects, rows in source-shard then source-row order."""
    cols, nulls = keyed_data()
    jt, tt = tables(cols, nulls)
    jout = ref("shuffle", lambda m: jpar.map_shards(
        m, _shuffle_body(jpar, 2048 // P), jpar.distribute(jt, m)))
    out = par.map_shards(mesh, _shuffle_body(par, 2048 // P),
                         par.distribute(tt, mesh))
    assert_sharded_match(jout, out)
    part = ops.partition_ids(tt, ["k"], P).numpy()
    first = {int(k): part[i] for i, k in enumerate(cols["k"])}
    for s, shard in enumerate(_torch_shards(out)):
        assert all(first[int(k)] == s for k in shard["k"][0])


def test_dist_groupby(mesh, ref):
    cols, nulls = keyed_data(seed=4, n=4096, nkeys=300, null_p=0.15)
    jt, tt = tables(cols, nulls)
    jout = ref("groupby", lambda m: jpar.dist_groupby(
        m, jpar.distribute(jt, m), ["k"], GB_AGGS))
    out = par.dist_groupby(mesh, par.distribute(tt, mesh), ["k"], GB_AGGS)
    assert_sharded_match(jout, out, GB_TOL)
    # and without the combiner
    jraw = ref("groupby_raw", lambda m: jpar.dist_groupby(
        m, jpar.distribute(jt, m), ["k"], GB_AGGS, pre_aggregate=False))
    raw = par.dist_groupby(mesh, par.distribute(tt, mesh), ["k"], GB_AGGS,
                           pre_aggregate=False)
    assert_sharded_match(jraw, raw, GB_TOL)


@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_dist_join(mesh, ref, how):
    left, right = join_data()
    (jl, tl), (jr, tr) = tables(left), tables(right)
    jout = ref(f"join_{how}", lambda m: jpar.dist_join(
        m, jpar.distribute(jl, m), jpar.distribute(jr, m), ["k"], ["k"],
        how=how))
    out = par.dist_join(mesh, par.distribute(tl, mesh),
                        par.distribute(tr, mesh), ["k"], ["k"], how=how)
    assert_sharded_match(jout, out)


def test_broadcast_join_matches_shuffle_join(mesh, ref):
    rng = np.random.default_rng(6)
    left = {"k": rng.integers(0, 100, 2048).astype(np.int32),
            "lv": rng.standard_normal(2048)}
    right = {"k": np.arange(128, dtype=np.int32),
             "rv": rng.standard_normal(128)}
    (jl, tl), (jr, tr) = tables(left), tables(right)
    jout = ref("broadcast", lambda m: jpar.broadcast_join(
        m, jpar.distribute(jl, m), jpar.distribute(jr, m), ["k"], ["k"]))
    sl, sr = par.distribute(tl, mesh), par.distribute(tr, mesh)
    out = par.broadcast_join(mesh, sl, sr, ["k"], ["k"])
    assert_sharded_match(jout, out)
    a = ops.sort_table(par.collect(out), ["k", "lv"])
    b = ops.sort_table(par.collect(par.dist_join(mesh, sl, sr, ["k"], ["k"])),
                       ["k", "lv"])
    for name in a.names:
        np.testing.assert_array_equal(a[name].data.numpy(),
                                      b[name].data.numpy())


def test_detect_skew_flags_hot_key(mesh, ref):
    rng = np.random.default_rng(7)
    n = 4096
    k = np.concatenate([np.full(n // 2, 7), rng.integers(100, 1000, n // 2)])
    jt, tt = tables({"k": k.astype(np.int64)})
    jhist, jhot = ref("skew", lambda m: jpar.detect_skew(
        m, jpar.distribute(jt, m), ["k"], num_bins=8))
    hist, hot = par.detect_skew(mesh, par.distribute(tt, mesh), ["k"],
                                num_bins=8)
    np.testing.assert_array_equal(hist, np.asarray(jhist))
    np.testing.assert_array_equal(hot, np.asarray(jhot))
    assert hist.sum() == n
    assert hot[int(ops.partition_ids(tt, ["k"], 8)[0])]


def test_global_partition_histogram(mesh):
    rng = np.random.default_rng(8)
    jt, tt = tables({"k": rng.integers(0, 50, 1024).astype(np.int32)})
    seen, lock = [], threading.Lock()

    def body(local):
        h = par.global_partition_histogram(local, ["k"], par.DEFAULT_AXIS, 8)
        with lock:
            seen.append(h.numpy())
        return local

    par.map_shards(mesh, body, par.distribute(tt, mesh))
    expect = np.bincount(np.asarray(jops.partition_ids(jt, ["k"], 8)),
                         minlength=8)
    assert len(seen) == P
    for h in seen:
        np.testing.assert_array_equal(h, expect)


def test_batched_shuffle_equals_monolithic(mesh, ref):
    cols, nulls = keyed_data(seed=9)
    jt, tt = tables(cols, nulls)
    jout = ref("batched", lambda m: jpar.map_shards(
        m, _shuffle_body(jpar, 512, 4), jpar.distribute(jt, m)))
    st = par.distribute(tt, mesh)
    for b in (1, 4):
        assert_sharded_match(jout, par.map_shards(
            mesh, _shuffle_body(par, 512, b), st))
    with pytest.raises(GDFError) as err:
        par.map_shards(mesh, _shuffle_body(par, 512, 3), st)
    assert err.value.status == GDFStatus.GDF_INVALID_API_CALL


def test_exact_slot_capacity_and_overflow_raises(mesh, ref):
    """Default sizing is exact; an explicit slot_capacity too small raises
    GDFError(GDF_COLUMN_SIZE_TOO_BIG) instead of dropping rows."""
    n = 512
    rng = np.random.default_rng(10)
    cols = {"k": np.full(n, 7, dtype=np.int64), "v": rng.standard_normal(n)}
    jt, tt = tables(cols)
    jst = jpar.distribute(jt, ref.mesh)
    st = par.distribute(tt, mesh)
    need = par.exact_slot_capacity(mesh, [(st, ["k"])])
    assert need == jpar.exact_slot_capacity(ref.mesh, [(jst, ["k"])]) == n // 8
    assert par.exact_slot_capacity(mesh, [(st, ["k"])], num_batches=3) == 66
    jout = ref("hot_self_join", lambda m: jpar.dist_join(
        m, jst, jst, ["k"], ["k"], out_capacity_per_shard=n * n))
    out = par.dist_join(mesh, st, st, ["k"], ["k"],
                        out_capacity_per_shard=n * n)
    assert int(out.total_rows()) == n * n
    assert_sharded_match(jout, out)
    with pytest.raises(JGDFError) as jerr:
        jpar.dist_join(ref.mesh, jst, jst, ["k"], ["k"], slot_capacity=8,
                       out_capacity_per_shard=n * n)
    with pytest.raises(GDFError) as err:
        par.dist_join(mesh, st, st, ["k"], ["k"], slot_capacity=8,
                      out_capacity_per_shard=n * n)
    assert err.value.status.value == jerr.value.status.value == \
        GDFStatus.GDF_COLUMN_SIZE_TOO_BIG


def test_dist_join_output_overflow_raises(mesh, ref):
    n = 512
    jt, tt = tables({"k": np.zeros(n, dtype=np.int64)})
    jst = jpar.distribute(jt, ref.mesh)
    with pytest.raises(ValueError, match="output overflow"):
        jpar.dist_join(ref.mesh, jst, jst, ["k"], ["k"],
                       out_capacity_per_shard=16)
    st = par.distribute(tt, mesh)
    with pytest.raises(ValueError, match="output overflow"):
        par.dist_join(mesh, st, st, ["k"], ["k"], out_capacity_per_shard=16)


def test_dropped_rows_raise_at_collect(mesh, ref):
    """The overflow flag: a shard-local shuffle whose slot is too small
    reports dropped rows, and collect() / total_rows() raise. (The JAX
    test_jitted_pipeline_overflow_raises_at_collect has no counterpart:
    the port has no jax.jit, so the same under-sized dist_groupby raises
    GDFError at the call, as the JAX package's eager call does.)"""
    n = 2048
    rng = np.random.default_rng(11)
    cols = {"k": np.full(n, 7, dtype=np.int64), "v": rng.standard_normal(n)}
    jt, tt = tables(cols)
    jout = ref("dropped", lambda m: jpar.map_shards(
        m, _shuffle_body(jpar, 8, overflow=True), jpar.distribute(jt, m)))
    out = par.map_shards(mesh, _shuffle_body(par, 8, overflow=True),
                         par.distribute(tt, mesh))
    np.testing.assert_array_equal(out.overflow.numpy(),
                                  np.asarray(jout.overflow))
    np.testing.assert_array_equal(out.counts.numpy(), np.asarray(jout.counts))
    for fn in (par.collect, lambda st: st.total_rows()):
        with pytest.raises(ValueError, match="dropped rows"):
            fn(out)
    with pytest.raises(ValueError, match="dropped rows"):
        jpar.collect(jout)
    st = par.distribute(tt, mesh)
    with pytest.raises(GDFError) as err:
        par.dist_groupby(mesh, st, ["k"], [("v", "sum", "s")],
                         slot_capacity=8, pre_aggregate=False)
    assert err.value.status == GDFStatus.GDF_COLUMN_SIZE_TOO_BIG
    with pytest.raises(JGDFError):
        jpar.dist_groupby(ref.mesh, jpar.distribute(jt, ref.mesh), ["k"],
                          [("v", "sum", "s")], slot_capacity=8,
                          pre_aggregate=False)
    good = par.dist_groupby(mesh, st, ["k"], [("v", "sum", "s")],
                            slot_capacity=n, pre_aggregate=False)
    assert par.collect(good).capacity == 1


def _salted(mod, m, jt_or_tt, how, **kw):
    lt, rt = jt_or_tt
    return mod.dist_join_salted(m, mod.distribute(lt, m),
                                mod.distribute(rt, m), ["k"], ["k"], how=how,
                                num_bins=64, threshold=3.0, **kw)


def test_salted_join_zipf(mesh, ref):
    """Half the probe rows on one key: the salted path spreads the hot probe
    rows and replicates the hot build rows."""
    left, right, _ = zipf_data(12, 4096, 512, 3, 0.5, 400)
    (jl, tl), (jr, tr) = tables(left), tables(right)
    jout = ref("salted", lambda m: _salted(jpar, m, (jl, jr), "inner"))
    assert_sharded_match(jout, _salted(par, mesh, (tl, tr), "inner"))


def test_salted_join_planned(mesh, ref):
    left, right, _ = zipf_data(13, 2048, 256, 7, 0.5, 300)
    (jl, tl), (jr, tr) = tables(left), tables(right)

    def jrun(m):
        sl, sr = jpar.distribute(jl, m), jpar.distribute(jr, m)
        plan = jpar.plan_salted_join(m, sl, sr, ["k"], ["k"], how="inner",
                                     num_bins=64, threshold=3.0)
        return plan, jpar.dist_join_salted(m, sl, sr, ["k"], ["k"],
                                           plan=plan)
    jplan, jout = ref("salted_planned", jrun)
    sl, sr = par.distribute(tl, mesh), par.distribute(tr, mesh)
    plan = par.plan_salted_join(mesh, sl, sr, ["k"], ["k"], how="inner",
                                num_bins=64, threshold=3.0)
    for f in ("slot_capacity", "hot_capacity_per_shard",
              "out_capacity_per_shard", "num_bins", "how", "left_on"):
        assert getattr(plan, f) == getattr(jplan, f), f
    np.testing.assert_array_equal(plan.hot.cpu().numpy(),
                                  np.asarray(jplan.hot))
    assert_sharded_match(jout, par.dist_join_salted(mesh, sl, sr, ["k"],
                                                    ["k"], plan=plan))
    for kw, status in (({"how": "left"}, "GDF_INVALID_API_CALL"),
                       ({"slot_capacity": plan.slot_capacity + 1},
                        "GDF_INVALID_API_CALL")):
        with pytest.raises(GDFError) as err:
            par.dist_join_salted(mesh, sl, sr, ["k"], ["k"], plan=plan, **kw)
        assert err.value.status == getattr(GDFStatus, status)
        with pytest.raises(JGDFError):
            jpar.dist_join_salted(ref.mesh, jpar.distribute(jl, ref.mesh),
                                  jpar.distribute(jr, ref.mesh), ["k"],
                                  ["k"], plan=jplan, **kw)


def test_salted_join_left_with_nulls(mesh, ref):
    left, right, lnull = zipf_data(14, 2048, 256, 11, 0.6, 600,
                                   unique_right=False)
    jl = libgdf_tpu.Table.from_dict(left, nulls={"k": lnull})
    tl = Table.from_dict(left, {"k": lnull}, device="cpu")
    jr, tr = tables(right)
    jout = ref("salted_left", lambda m: _salted(jpar, m, (jl, jr), "left"))
    assert_sharded_match(jout, _salted(par, mesh, (tl, tr), "left"))


# -- the port's own cases -----------------------------------------------------

def test_shards_left_with_zero_rows(mesh, ref):
    """Three keys: after the shuffle at most three shards hold rows, and the
    others run the local groupby and join at zero rows."""
    rng = np.random.default_rng(15)
    n = 1024
    cols = {"k": rng.choice([3, 11, 40], n).astype(np.int64),
            "v": rng.standard_normal(n)}
    nulls = {"v": rng.random(n) < 0.2}
    jt, tt = tables(cols, nulls)
    dim = {"k": np.array([3, 40, 99], np.int64), "w": np.arange(3.0)}
    jd, td = tables(dim)
    jgb = ref("zero_gb", lambda m: jpar.dist_groupby(
        m, jpar.distribute(jt, m), ["k"], GB_AGGS))
    gb = par.dist_groupby(mesh, par.distribute(tt, mesh), ["k"], GB_AGGS)
    assert_sharded_match(jgb, gb, GB_TOL)
    assert (gb.counts == 0).sum() >= P - 3
    jj = ref("zero_join", lambda m: jpar.dist_join(
        m, jpar.distribute(jt, m), jpar.distribute(jd, m), ["k"], ["k"],
        how="left", out_capacity_per_shard=2 * n))
    j = par.dist_join(mesh, par.distribute(tt, mesh),
                      par.distribute(td, mesh), ["k"], ["k"], how="left",
                      out_capacity_per_shard=2 * n)
    assert_sharded_match(jj, j)


def test_distribute_fewer_rows_than_shards(mesh):
    """Five rows over eight shards: shards 5-7 are live with zero rows.
    (The JAX package's counts give the last shard per - pad = -2 here;
    ROADMAP C "Reference side".)"""
    _, tt = tables({"k": np.arange(5, dtype=np.int64)})
    st = par.distribute(tt, mesh)
    assert st.counts.tolist() == [1, 1, 1, 1, 1, 0, 0, 0]
    gb = par.dist_groupby(mesh, st, ["k"], [("k", "count", "n")])
    assert par.collect(gb)["n"].data.tolist() == [1] * 5


def test_join_types_and_api_errors(mesh, ref):
    left, right = join_data()
    (jl, tl), (jr, tr) = tables(left), tables(right)
    jsl, jsr = jpar.distribute(jl, ref.mesh), jpar.distribute(jr, ref.mesh)
    sl, sr = par.distribute(tl, mesh), par.distribute(tr, mesh)
    cases = [
        (lambda mod, m, a, b: mod.broadcast_join(m, a, b, ["k"], ["k"],
                                                 how="full"),
         GDFStatus.GDF_UNSUPPORTED_JOIN_TYPE),
        (lambda mod, m, a, b: mod.dist_join_salted(m, a, b, ["k"], ["k"],
                                                   how="full"),
         GDFStatus.GDF_UNSUPPORTED_JOIN_TYPE),
        (lambda mod, m, a, b: mod.dist_join(m, a, b, ["k"], ["k"],
                                            how="cross"),
         GDFStatus.GDF_UNSUPPORTED_JOIN_TYPE),
    ]
    for call, status in cases:
        with pytest.raises(JGDFError) as jerr:
            call(jpar, ref.mesh, jsl, jsr)
        with pytest.raises(GDFError) as err:
            call(par, mesh, sl, sr)
        assert err.value.status == status == jerr.value.status.value
    with pytest.raises(JGDFError) as jerr:
        jpar.distribute(jl.with_num_rows(10), ref.mesh)
    with pytest.raises(GDFError) as err:
        par.distribute(tl.with_num_rows(10), mesh)
    assert err.value.status == GDFStatus.GDF_INVALID_API_CALL == \
        jerr.value.status.value


class _Boom(Exception):
    pass


def test_one_shard_raising_alone_is_raised_with_its_type(mesh):
    """Rank 3 raises before a collective its peers wait in: the barrier is
    aborted and the caller sees rank 3's exception, not a hang."""
    _, tt = tables({"k": np.arange(64, dtype=np.int64)})

    def body(local):
        if comm.axis_index(par.DEFAULT_AXIS) == 3:
            raise _Boom("rank 3")
        comm.psum(1, par.DEFAULT_AXIS)
        return local

    with pytest.raises(_Boom, match="rank 3"):
        par.map_shards(mesh, body, par.distribute(tt, mesh))


def test_a_collective_one_rank_skips_times_out(mesh, monkeypatch):
    monkeypatch.setattr(comm, "COLLECTIVE_TIMEOUT", 0.5)
    _, tt = tables({"k": np.arange(64, dtype=np.int64)})

    def body(local):
        if comm.axis_index(par.DEFAULT_AXIS) != 0:
            comm.pmax(1, par.DEFAULT_AXIS)
        return local

    with pytest.raises(TimeoutError):
        par.map_shards(mesh, body, par.distribute(tt, mesh))
