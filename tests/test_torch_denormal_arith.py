"""Denormal floats in arithmetic, sums and widenings, against libgdf_tpu.

XLA reads a denormal float as zero wherever it enters arithmetic or a
widening, on the CPU as on the TPU; torch does not. The port flushes each
float input in its own dtype, before any promotion or widening: a float32
denormal widened to float64, scaled by a large factor or accumulated is a
normal number, which no later flush would catch. These cases run the same
numpy columns through both packages on the CPU and must match exactly
(NaN equals NaN): add / sub / mul against each float dtype and int32 /
int64, both ways round; the sum, product and sum-of-squares reductions;
`prefixsum`; groupby `sum` / `avg`; the window sum family in ROW running,
ROW bounded and RANGE frames; `quantile_exact`; the ABI names that reach
them; `dist_groupby`. The named examples are the faults' own.

Values that enter a sum are zeros, denormals and small multiples of a
normal unit u, so that every sum is exact in any order of addition (the
two packages add in different orders) and is 0 or at least u: u is
finfo.tiny for the sums, and 1024 x finfo.tiny where a sum is divided by
a count (an average or a variance), whose result must not be denormal.
A denormal *result* is the one difference that stays: the JAX package
flushes it, the port returns it to the user (float32 1.5e-38 - 1.4e-38 is
0.0 there, 1e-39 here). Elementwise cases also meet normal values, NaN and
inf. `lower` / `higher` / `nearest` quantiles of float64 read the sorted
column's value as stored, and the sort leaves denormals and zeros in no
order (ROADMAP queue C, "Reference side"), so there the two must agree as
zeros.

A bitwise op on a float column raises TypeError in both packages.
"""
import functools

import jax
import numpy as np
import pytest

import libgdf_tpu
from libgdf_tpu import ops as jops
from libgdf_tpu import parallel as jpar
from libgdf_tpu.compat import gdf as jgdf
from libgdf_tpu_torch import Column, ops
from libgdf_tpu_torch import parallel as par
from libgdf_tpu_torch.compat import gdf
from torch_parity import assert_tables_match, jax_op, make_tables, np_of

F32, F64 = np.float32, np.float64
DENORMAL = {F32: F32(1e-40), F64: F64(1e-310)}
ARITH = ("add", "sub", "mul")
SUM_AGGS = (("v", "sum", "s"), ("v", "count", "c"), ("v", "avg", "a"))
# frame -> window_function's frame arguments
FRAMES = {"running": dict(preceding=None), "rows": dict(preceding=3),
          "range": dict(preceding=30, frame="range")}
WINDOW_SUMS = ("sum", "avg", "var", "stddev", "count")
QMETHODS = ("linear", "lower", "higher", "midpoint", "nearest")


def both(values, null=None):
    valid = None if null is None else ~null
    return (libgdf_tpu.Column.from_array(values, valid=valid),
            Column.from_array(values, valid=valid, device="cpu"))


def same(want, got, what=""):
    """Values exact, NaN equal to NaN, dtypes equal."""
    want, got = np.asarray(np_of(want)), np.asarray(np_of(got))
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def same_column(jc, tc, what=""):
    """Validity and the valid rows' values exact."""
    assert (tc.valid is None) == (jc.valid is None), what
    ok = np.ones(jc.size, bool)
    if jc.valid is not None:
        ok = np_of(jc.valid)
        np.testing.assert_array_equal(np_of(tc.valid), ok, err_msg=what)
    jd, td = np_of(jc.data), np_of(tc.data)
    assert td.dtype == jd.dtype, (what, td.dtype, jd.dtype)
    np.testing.assert_array_equal(td[ok], jd[ok], err_msg=what)


def sum_values(rng, dtype, n, mean=False):
    """Zeros, +-denormals and small multiples of a normal unit u
    (finfo.tiny, or 1024 finfo.tiny for a `mean`): sums of them are exact
    in any order and are 0 or at least u."""
    d, s = DENORMAL[dtype], np.finfo(dtype).smallest_subnormal
    u = np.finfo(dtype).tiny * (1024 if mean else 1)
    return rng.choice(np.array([0.0, -0.0, d, -d, 2 * d, s, u, -u, 3 * u],
                               dtype), n)


def edge_values(rng, dtype, n):
    """sum_values' values, normal values, NaN and +-inf."""
    d, t = DENORMAL[dtype], np.finfo(dtype).tiny
    return rng.choice(np.array([0.0, -0.0, d, -d, 2 * d, t, -t, 1.5, -1.5,
                                1e30, np.nan, np.inf, -np.inf], dtype), n)


@functools.lru_cache(maxsize=None)
def _jax_arith():
    """add / sub / mul of every (a, b) pair in one compile."""
    return jax.jit(lambda pairs: [[jops.binary_op(a, b, op) for op in ARITH]
                                  for a, b in pairs])


@functools.lru_cache(maxsize=None)
def _jax_reductions():
    return jax.jit(lambda c: [jops.reduce(c, op) for op in
                              ("sum", "product", "sum_squared", "min",
                               "max")])


@functools.lru_cache(maxsize=None)
def _jax_windows():
    """{frame: the WINDOW_SUMS over it} for every frame in one compile."""
    return jax.jit(lambda t: {f: [
        jops.window_function(t, "v", r, partition_by=("p",), order_by=("o",),
                             **kw) for r in WINDOW_SUMS]
        for f, kw in FRAMES.items()})


@functools.lru_cache(maxsize=None)
def _jax_quantiles(q):
    return jax.jit(lambda c: [jops.quantile_exact(c, q, m)
                              for m in QMETHODS])


# -- the faults' examples ------------------------------------------------------

def _arith(op, a, b):
    (ja, ta), (jb, tb) = both(np.asarray(a)), both(np.asarray(b))
    return (jax.jit(lambda x, y: jops.binary_op(x, y, op))(ja, jb).data,
            ops.binary_op(ta, tb, op).data)


def _reduce(op, values):
    jc, tc = both(np.asarray(values))
    return jax.jit(lambda c: jops.reduce(c, op))(jc), ops.reduce(tc, op)


def _last_prefixsum(values):
    jc, tc = both(np.asarray(values))
    return (jax_op("prefixsum", jc).data[-1:],
            ops.prefixsum(tc).data[-1:])


def _group(op, values):
    cols = {"k": np.zeros(len(values), np.int32), "v": np.asarray(values)}
    jt, tt = make_tables(cols)
    aggs = (("v", op, "out"),)
    jg = jax_op("groupby", jt, key_names=("k",), aggs=aggs)
    tg = ops.groupby(tt, ["k"], list(aggs))
    return jg["out"].data[:1], tg["out"].data[:1]


def _scaled_row_kept():
    """float32 1e-40 * 1e30 > 0: the row set of a filter on the product."""
    (ja, ta), (jb, tb) = both(np.array([1e-40], F32)), \
        both(np.array([1e30], F32))
    jm = jax.jit(lambda x, y: jops.compare_scalar(
        jops.binary_op(x, y, "mul"), 0.0, "gt"))(ja, jb)
    tm = ops.compare_scalar(ops.binary_op(ta, tb, "mul"), 0.0, "gt")
    return jm.data, tm.data


EXAMPLES = {
    "f32 1e-40 + f64 0.0": lambda: _arith(
        "add", np.array([1e-40], F32), np.array([0.0])),
    "f32 1e-45 * f64 1e300": lambda: _arith(
        "mul", np.array([1e-45], F32), np.array([1e300])),
    "f32 1e-40 * f32 1e30": lambda: _arith(
        "mul", np.array([1e-40], F32), np.array([1e30], F32)),
    "f32 1e-40 * 1e30 > 0 keeps no row": _scaled_row_kept,
    "f64 1e308 * 5e-324": lambda: _arith(
        "mul", np.array([1e308]), np.array([5e-324])),
    "f32 1e-40 + 1.2e-38": lambda: _arith(
        "add", np.array([1e-40], F32), np.array([1.2e-38], F32)),
    "product of f32 [1e-40, 1e30]": lambda: _reduce(
        "product", np.array([1e-40, 1e30], F32)),
    "sum of 300 f32 1e-40": lambda: _reduce(
        "sum", np.full(300, 1e-40, F32)),
    "prefixsum of 300 f32 1e-40": lambda: _last_prefixsum(
        np.full(300, 1e-40, F32)),
    "groupby sum of 300 f32 1e-40": lambda: _group(
        "sum", np.full(300, 1e-40, F32)),
    "sum of 300 f64 1e-310": lambda: _reduce(
        "sum", np.full(300, 1e-310)),
    "prefixsum of 300 f64 1e-310": lambda: _last_prefixsum(
        np.full(300, 1e-310)),
    "groupby sum of 300 f64 1e-310": lambda: _group(
        "sum", np.full(300, 1e-310)),
    "groupby avg of f32 {1e-40, 1e-40}": lambda: _group(
        "avg", np.full(2, 1e-40, F32)),
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_fault_example(name):
    want, got = EXAMPLES[name]()
    same(want, got, name)
    assert not np.any(np.abs(np_of(got)) == 9.9999461e-41)


@pytest.mark.parametrize("frame", list(FRAMES))
def test_fault_example_window_sums(frame):
    """float32 [1e-40, 1e-40, -1e-40, 1e-40]: sum, avg, var all 0.0."""
    cols = {"p": np.zeros(4, np.int32), "o": np.arange(4, dtype=np.int32),
            "v": np.array([1e-40, 1e-40, -1e-40, 1e-40], F32)}
    jt, tt = make_tables(cols)
    kw = FRAMES[frame]
    wants = _jax_windows()(jt)[frame]
    for red, w in zip(WINDOW_SUMS, wants):
        g = ops.window_function(tt, "v", red, partition_by=["p"],
                                order_by=["o"], **kw)
        same_column(w, g, red)
        if red != "count":
            assert not np_of(g.data).any(), red


def test_fault_example_quantile():
    """float32 [1e-40, 2e-40, 3e-40, 5e-40] at 0.5: 0.0 for every method."""
    jc, tc = both(np.array([1e-40, 2e-40, 3e-40, 5e-40], F32))
    for m, w in zip(QMETHODS, _jax_quantiles(0.5)(jc)):
        got = ops.quantile_exact(tc, 0.5, m)
        same(w, got, m)
        assert float(got) == 0.0, m


# -- every route, at float32 and float64 ---------------------------------------

def _partners(rng, dtype, n):
    """The columns a denormal column meets: its own dtype, the other float
    dtype, and int32 / int64."""
    other = F64 if dtype == F32 else F32
    ints = rng.integers(-3, 4, n)
    return (edge_values(rng, dtype, n), edge_values(rng, other, n),
            ints.astype(np.int32), ints.astype(np.int64))


@pytest.mark.parametrize("dtype", [F32, F64])
def test_add_sub_mul_of_denormals(rng, dtype):
    n = 200
    x = edge_values(rng, dtype, n)
    null = rng.random(n) < 0.1
    pairs = [(both(a, null), both(b)) for p in _partners(rng, dtype, n)
             for a, b in ((x, p), (p, x))]
    wants = _jax_arith()([(ja, jb) for (ja, _), (jb, _) in pairs])
    for ((_, ta), (_, tb)), per_op in zip(pairs, wants):
        for op, want in zip(ARITH, per_op):
            what = f"{ta.data.dtype} {op} {tb.data.dtype}"
            same_column(want, ops.binary_op(ta, tb, op), what)
            same_column(want, getattr(ops, op)(ta, tb), what)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("with_nulls", [False, True])
def test_reductions_of_denormals(rng, dtype, with_nulls):
    n = 300
    jc, tc = both(sum_values(rng, dtype, n),
                  rng.random(n) < 0.2 if with_nulls else None)
    ops_ = ("sum", "product", "sum_squared", "min", "max")
    for op, want in zip(ops_, _jax_reductions()(jc)):
        same(want, ops.reduce(tc, op), op)
    # a product that a denormal would bring back into the normal range
    jc, tc = both(np.array([1e30, 1e-40 if dtype == F32 else 1e-310, 1e30],
                           dtype))
    for op, want in zip(ops_, _jax_reductions()(jc)):
        same(want, ops.reduce(tc, op), op)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("inclusive", [True, False])
def test_prefixsum_of_denormals(rng, dtype, inclusive):
    jc, tc = both(sum_values(rng, dtype, 300))
    same(jax_op("prefixsum", jc, inclusive=inclusive).data,
         ops.prefixsum(tc, inclusive).data)


def _sum_table(rng, dtype, n=300, nkeys=12):
    cols = {"k": rng.integers(0, nkeys, n).astype(np.int32),
            "v": sum_values(rng, dtype, n, mean=True)}
    return make_tables(cols, {"v": rng.random(n) < 0.1})


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("aggs", [SUM_AGGS, (("v", "avg", "a"),)],
                         ids=["sum_count_avg", "avg_alone"])
def test_groupby_sum_avg_of_denormals(rng, dtype, aggs):
    """avg beside sum and count divides their results (float32: the sum
    widened to float64); avg alone runs its own float64 scan."""
    jt, tt = _sum_table(rng, dtype)
    jg = jax_op("groupby", jt, key_names=("k",), aggs=aggs)
    tg = ops.groupby(tt, ["k"], list(aggs))
    assert int(tg.num_rows) == int(jg.num_rows)
    assert_tables_match(jg, tg)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("frame", list(FRAMES))
def test_window_sums_of_denormals(rng, dtype, frame):
    n = 300
    cols = {"p": rng.integers(0, 4, n).astype(np.int32),
            "o": rng.permutation(n).astype(np.int32),
            "v": sum_values(rng, dtype, n, mean=True)}
    jt, tt = make_tables(cols, {"v": rng.random(n) < 0.15})
    kw = FRAMES[frame]
    wants = _jax_windows()(jt)[frame]
    u = np.finfo(dtype).tiny * 1024
    for red, w in zip(WINDOW_SUMS, wants):
        g = ops.window_function(tt, "v", red, partition_by=["p"],
                                order_by=["o"], **kw)
        if red in ("var", "stddev"):
            # the variance's last bits depend on how its float64 products
            # are rounded (rtol 1e-9 as tests/test_torch_window.py, with an
            # absolute 1e-9 of a unit's square in place of its 1e-9);
            # stddev through its square, as there
            np.testing.assert_array_equal(np_of(g.valid), np_of(w.valid))
            ok = np_of(w.valid)
            gd, wd = np_of(g.data)[ok], np_of(w.data)[ok]
            if red == "stddev":
                gd, wd = gd * gd, wd * wd
            np.testing.assert_allclose(gd, wd, rtol=1e-9,
                                       atol=1e-9 * float(u) ** 2,
                                       err_msg=red)
        else:
            same_column(w, g, red)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("q", [0.0, 0.3, 0.5, 1.0])
def test_quantiles_of_denormals(rng, dtype, q):
    d = DENORMAL[dtype]
    values = np.array([d, 2 * d, 3 * d, 5 * d, -d, 0.0, 1.5], dtype)
    jc, tc = both(values, np.array([0, 0, 0, 0, 0, 0, 1], bool))
    for m, w in zip(QMETHODS, _jax_quantiles(q)(jc)):
        got = ops.quantile_exact(tc, q, m)
        if dtype == F64 and m in ("lower", "higher", "nearest"):
            # a value as stored, from ties in no order: both must be zero
            w, got = (np.where(np.abs(np_of(v)) < np.finfo(F64).tiny, 0.0,
                               np_of(v)) for v in (w, got))
        same(w, got, m)


# -- the ABI names and the distributed layer -----------------------------------

@pytest.mark.parametrize("dtype", [F32, F64])
def test_abi_names_of_denormals(rng, dtype):
    n = 200
    sfx = "f32" if dtype == F32 else "f64"
    (jx, tx), (jy, ty) = (both(edge_values(rng, dtype, n)) for _ in "xy")
    (js, ts) = both(sum_values(rng, dtype, n))
    keys = rng.integers(0, 7, n).astype(np.int32)
    (jk, tk) = both(keys)
    vals = sum_values(rng, dtype, n, mean=True)
    (jv, tv) = both(vals)
    arith = [f"gdf_{op}_{s}" for op in ARITH for s in (sfx, "generic")]
    sums = [f"gdf_{op}_{s}" for op in ("sum", "product", "sum_squared")
            for s in (sfx, "generic")]
    # every jitted ABI call of the JAX package in one compile
    jarith, jsums, jprefix, jw = jax.jit(lambda x, y, s, v, k: (
        [getattr(jgdf, name)(x, y) for name in arith],
        [getattr(jgdf, name)(s) for name in sums],
        jgdf.gdf_prefixsum_generic(s),
        jgdf.gdf_window_function(v, "sum", "row", 5, (k,), (k,))))(
            jx, jy, js, jv, jk)
    for name, want in zip(arith, jarith):
        same_column(want, getattr(gdf, name)(tx, ty), name)
    for name, want in zip(sums, jsums):
        same(want, getattr(gdf, name)(ts), name)
    same_column(jprefix, gdf.gdf_prefixsum_generic(ts),
                "gdf_prefixsum_generic")
    # the JAX package's gdf_group_by_* compacts on the host, so it runs
    # jitted up to its groupby
    jt = make_tables({"k0": keys, "__agg": vals})[0]
    for op in ("sum", "avg"):
        jg = jax_op("groupby", jt, key_names=("k0",),
                    aggs=(("__agg", op, "__out"),)).compact()
        tkeys, tout = getattr(gdf, f"gdf_group_by_{op}")(1, [tk], tv)
        same_column(jg["k0"], tkeys[0], op)
        same_column(jg["__out"], tout, op)
    tw = gdf.gdf_window_function(tv, "sum", "row", 5, (tk,), (tk,))
    same_column(jw, tw, "gdf_window_function")


def test_dist_groupby_of_denormals():
    n = 1024
    rng = np.random.default_rng(7)
    cols = {"k": rng.integers(0, 50, n).astype(np.int64),
            "v": sum_values(rng, F32, n, mean=True)}
    nulls = {"v": rng.random(n) < 0.1}
    jt = libgdf_tpu.Table.from_dict(cols, nulls=nulls)
    tt = par.distribute(make_tables(cols, nulls)[1],
                        mesh := par.make_mesh(device="cpu"))
    jm = jpar.make_mesh()
    for pre in (True, False):
        jout = jpar.collect(jpar.dist_groupby(
            jm, jpar.distribute(jt, jm), ["k"], SUM_AGGS,
            pre_aggregate=pre)).compact()
        out = par.collect(par.dist_groupby(mesh, tt, ["k"], SUM_AGGS,
                                           pre_aggregate=pre)).compact()
        jorder = np.argsort(np_of(jout["k"].data))
        torder = np.argsort(np_of(out["k"].data))
        for name in jout.names:
            jv, jn = jout[name].to_numpy_masked()
            tv, tn = out[name].to_numpy_masked()
            np.testing.assert_array_equal(tn[torder], jn[jorder], name)
            ok = ~jn[jorder]
            np.testing.assert_array_equal(tv[torder][ok], jv[jorder][ok],
                                          name)


# -- C8: bitwise ops on floats ------------------------------------------------

@pytest.mark.parametrize("op", ["bitwise_and", "bitwise_or", "bitwise_xor"])
def test_bitwise_op_on_floats_raises_type_error(op):
    ints = np.arange(4, dtype=np.int32)
    floats = np.array([1.0, 2.0, 3.0, 4.0], F32)
    for a, b in ((floats, floats), (ints, floats), (floats, ints)):
        (ja, ta), (jb, tb) = both(a), both(b)
        with pytest.raises(TypeError):
            jops.binary_op(ja, jb, op)
        with pytest.raises(TypeError):
            ops.binary_op(ta, tb, op)
        with pytest.raises(TypeError):
            getattr(ops, op)(ta, tb)
