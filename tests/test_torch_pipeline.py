"""The whole slice, libgdf_tpu_torch against libgdf_tpu, on the CPU.

tests/test_pipeline_fuzz.py's pipeline — filter -> inner join -> groupby
(sum / count / avg / max) -> order_by — runs through both packages on the
same numpy inputs, and every intermediate table is compared.

Tolerances: row counts, keys, join outputs, counts, maxima, validity and
row order exact; float32 sums and the averages taken from them rtol=1e-4,
atol=1e-4 (the groupby sort and the scans add in another order, as in
tests/test_pipeline_fuzz.py:73-74).
"""
import numpy as np
import pytest

import libgdf_tpu.ops as jops
import libgdf_tpu_torch.ops as tops
from libgdf_tpu_torch.interop import from_numpy
from torch_parity import assert_tables_match, jax_to_numpy, make_tables, np_of

import jax

AGGS = (("v", "sum", "s"), ("v", "count", "c"), ("v", "avg", "a"),
        ("w", "max", "hi"))
TOL = {"s": (1e-4, 1e-4), "a": (1e-4, 1e-4)}
N, ND = 1500, 48   # fixed shapes: the JAX pipeline compiles once per dtype


def _pipeline(O, fact, dim, thresh, how, cap):
    filt = O.filter_table(fact, O.compare_scalar(fact["v"], thresh, "lt"))
    joined = O.join(filt, dim, ["k"], ["k"], how=how, out_capacity=cap)
    gb = O.groupby(joined, ["k"], AGGS)
    perm = O.order_by(gb, ["s"], ascending=False, nulls_last=True)
    return filt, joined, gb, perm


_jax_pipeline = jax.jit(
    lambda fact, dim, thresh, how, cap: _pipeline(jops, fact, dim, thresh,
                                                  how, cap),
    static_argnames=("how", "cap"))


def _inputs(seed, kdt, dup):
    rng = np.random.default_rng(seed)
    nkeys = int(rng.integers(5, 60))
    stretch = kdt == np.int64 and seed % 2 == 1
    keys = rng.integers(0, nkeys, N).astype(kdt)
    dk = rng.permutation(2 * max(nkeys, ND))[:ND // 3 if dup else ND]
    dk = (np.repeat(dk, 3) if dup else dk).astype(kdt)
    if stretch:  # past 2^32: the uncompressed 64-bit sort branches
        keys = keys + (keys % 3).astype(kdt) * kdt(1 << 40)
        dk = dk + (dk % 3).astype(kdt) * kdt(1 << 40)
    v = rng.standard_normal(N).astype(np.float32)
    fact = ({"k": keys, "v": v},
            {"k": rng.random(N) < rng.uniform(0, 0.2),
             "v": rng.random(N) < rng.uniform(0, 0.2)})
    dim = {"k": dk, "w": rng.standard_normal(ND).astype(np.float32)}
    thresh = float(np.quantile(v, rng.uniform(0.2, 0.8)))
    return fact, dim, thresh


def _check(seed, kdt, dup, how):
    (fc, fn), dc, thresh = _inputs(seed, kdt, dup)
    jfact, tfact = make_tables(fc, fn)
    jdim, tdim = make_tables(dc)
    cap = 3 * N if dup else N
    jf, jj, jg, jp = _jax_pipeline(jfact, jdim, np.float32(thresh), how, cap)
    tf, tj, tg, tp = _pipeline(tops, tfact, tdim, thresh, how, cap)

    assert int(tf.num_rows) == int(jf.num_rows)
    assert_tables_match(jf, tf)
    assert int(tj.num_rows) == int(jj.num_rows)
    assert_tables_match(jj, tj)
    assert int(tg.num_rows) == int(jg.num_rows)
    assert_tables_match(jg, tg, TOL)

    # order_by, exact, on identical input: the JAX groupby's output
    values, nulls = jax_to_numpy(jg)
    again = tops.order_by(from_numpy(values, nulls, device="cpu"), ["s"],
                          ascending=False, nulls_last=True)
    g = len(values["s"])
    np.testing.assert_array_equal(np_of(again), np_of(jp)[:g])
    # and the port's own order sorts its own sums the same way
    tv = np_of(tg["s"].data)[np_of(tp)[:g]]
    jv = values["s"][np_of(jp)[:g]]
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("kdt", [np.int32, np.int64])
def test_pipeline_matches_jax(seed, kdt):
    _check(seed, kdt, dup=False, how="inner")


@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_pipeline_duplicate_build_keys(how):
    """Build keys repeated 3 times: the join's general path (H4 on CUDA)."""
    _check(4, np.int64, dup=True, how=how)


# -- the analytic path: windows, prefix sums, reductions, quantiles ---------

NA, PARTS = 5000, 7
WINDOWS = (("v", "min", 100, ("p",), "rows"),
           ("v", "sum", 100, ("p",), "rows"),
           ("v", "avg", None, ("p",), "rows"),
           ("v", "sum", NA // 4, (), "range"),
           ("v", "max", NA // 4, ("p",), "range"))
QMETHODS = ("linear", "lower", "higher", "midpoint", "nearest")


def _analytic(O, W):
    """chip_smoke.py's analytic path: five windows over (p, o), prefix
    sums of q and x, reductions and quantiles of v."""
    out = [O.window_function(W, val, red, preceding=prec, partition_by=pb,
                             order_by=("o",), frame=frame)
           for val, red, prec, pb, frame in WINDOWS]
    out += [O.prefixsum(W["q"], True), O.prefixsum(W["q"], False),
            O.prefixsum(W["x"], True)]
    out += [O.reduce(W["v"], op) for op in
            ("sum", "min", "max", "product", "sum_squared")]
    out += [O.quantile_exact(W["v"], 0.5, m) for m in QMETHODS]
    out.append(O.quantile_approx(W["v"], 0.5))
    return out


_jax_analytic = jax.jit(lambda W: _analytic(jops, W))


def analytic_data(rng, n, parts):
    """The analytic table: partition p, order o (a permutation), value v
    (float32, 10% NULL), q (int64 in [-2^40, 2^40)) and x (float64)."""
    cols = {"p": rng.integers(0, parts, n).astype(np.int32),
            "o": rng.permutation(n).astype(np.int32),
            "v": rng.standard_normal(n).astype(np.float32),
            "q": rng.integers(-2**40, 2**40, n),
            "x": rng.standard_normal(n)}
    return cols, {"v": rng.random(n) < 0.10}


def test_analytic_path_matches_jax():
    """Windows: min / max / count and validity exact, sums and averages
    rtol=1e-9, atol=1e-9 (float64 prefix sums in another order); prefix
    sums of q exact, of x within 1e-12 of the running sum of |x|; integer
    results and quantiles exact; float32 reductions rtol=1e-5 with
    atol=1e-5 * sum|v| (another summation order)."""
    cols, nulls = analytic_data(np.random.default_rng(7), NA, PARTS)
    jt, tt = make_tables(cols, nulls)
    want = _jax_analytic(jt)
    got = _analytic(tops, tt)
    for (_, red, *_), g, w in zip(WINDOWS, got[:5], want[:5]):
        gv, wv = np_of(g.valid), np_of(w.valid)
        np.testing.assert_array_equal(gv, wv, err_msg=red)
        assert gv.sum() > NA // 2
        gd, wd = np_of(g.data)[wv], np_of(w.data)[wv]
        if red in ("min", "max"):
            np.testing.assert_array_equal(gd, wd, err_msg=red)
        else:
            np.testing.assert_allclose(gd, wd, rtol=1e-9, atol=1e-9,
                                       err_msg=red)
    for g, w in zip(got[5:7], want[5:7]):
        np.testing.assert_array_equal(np_of(g.data), np_of(w.data))
    bound = 1e-12 * np.cumsum(np.abs(cols["x"])) + 1e-12
    assert (np.abs(np_of(got[7].data) - np_of(want[7].data)) <= bound).all()
    for i, (g, w) in enumerate(zip(got[8:], want[8:])):
        g, w = np_of(g), np_of(w)
        assert g.dtype == w.dtype, i
        if i in (0, 3, 4):        # float32 sum, product, sum of squares
            scale = np.abs(cols["v"].astype(np.float64)).sum()
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * scale)
        else:
            assert g == w, i
