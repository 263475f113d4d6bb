"""libgdf_tpu_torch.ops.window_function against libgdf_tpu, on the CPU.

Both packages get the same numpy table; every reduction's output column is
compared row by row in input order, validity included.

Tolerances: min, max, count and validity exact; sum, avg and var
rtol=1e-9, atol=1e-9 (the float64 prefix sums add in another order: the
JAX package's CPU path runs XLA's cumsum, the port torch.cumsum). stddev
is held to the same tolerance through its square: where a frame's variance
is ~0, the prefix-sum difference leaves a cancellation error of ~1e-12
that the square root lifts to ~1e-6 in either package.
"""
import functools

import jax
import numpy as np
import pytest

import libgdf_tpu.ops as jops
from libgdf_tpu_torch import ops as tops
from libgdf_tpu_torch.core.errors import GDFError, GDFStatus
from torch_parity import make_tables, np_of

REDS = ("sum", "min", "max", "count", "avg", "stddev", "var")
EXACT = ("min", "max", "count")
N = 300


@functools.lru_cache(maxsize=None)
def _jax_windows(reds, kw):
    """One jitted JAX function computing several reductions of one frame:
    one compile per test instead of one per reduction."""
    return jax.jit(lambda t: [jops.window_function(t, "v", r, **dict(kw))
                              for r in reds])


def _check(cols, nulls=None, num_rows=None, reds=REDS, **kw):
    jt, tt = make_tables(cols, nulls, num_rows=num_rows)
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
    want = _jax_windows(tuple(reds), tuple(sorted(kw.items())))(jt)
    for red, w in zip(reds, want):
        g = tops.window_function(tt, "v", red, **kw)
        assert g.name == w.name == f"v_{red}"
        assert g.info.gdf_dtype.value == w.info.gdf_dtype.value
        gv, wv = np_of(g.valid), np_of(w.valid)
        np.testing.assert_array_equal(gv, wv, err_msg=red)
        gd, wd = np_of(g.data)[wv], np_of(w.data)[wv]
        assert gd.dtype == wd.dtype == np.float64
        if red in EXACT:
            np.testing.assert_array_equal(gd, wd, err_msg=red)
        elif red == "stddev":
            np.testing.assert_allclose(gd * gd, wd * wd, rtol=1e-9,
                                       atol=1e-9, err_msg=red)
        else:
            np.testing.assert_allclose(gd, wd, rtol=1e-9, atol=1e-9,
                                       err_msg=red)


def _table(rng, n=N, nparts=4, vdtype=np.float64, odtype=np.int32,
           ties=False):
    cols = {"p": rng.integers(0, nparts, n).astype(np.int32),
            "o": (rng.integers(0, n // 5, n) if ties
                  else rng.permutation(n)).astype(odtype),
            "v": (rng.standard_normal(n) * 10).astype(vdtype)}
    nulls = {"v": rng.random(n) < 0.15}
    return cols, nulls


@pytest.mark.parametrize("preceding", [5, None])
@pytest.mark.parametrize("vdtype", [np.float64, np.float32, np.int32])
def test_rows_every_reduction(rng, preceding, vdtype):
    cols, nulls = _table(rng, vdtype=vdtype)
    _check(cols, nulls, preceding=preceding, partition_by=["p"],
           order_by=["o"])


@pytest.mark.parametrize("w", [1, 2, 7, 8, 50, N + 3])
def test_rows_minmax_ladder_widths(rng, w):
    """The two-block ladder at power-of-two edges (w=8: the second block is
    a zero shift; w=1: no ladder; w > n: the running frame)."""
    cols, nulls = _table(rng, nparts=5)
    _check(cols, nulls, reds=("min", "max", "sum"), preceding=w,
           partition_by=["p"], order_by=["o"])


def test_rows_without_partition_or_order(rng):
    cols, nulls = _table(rng)
    _check(cols, nulls, preceding=4, order_by=["o"])
    _check(cols, nulls, reds=("sum", "max"), preceding=3)


@pytest.mark.parametrize("num_rows", [0, 1, 211])
def test_rows_dead_rows_are_skipped(rng, num_rows):
    cols, nulls = _table(rng)
    _check(cols, nulls, num_rows=num_rows, preceding=6,
           partition_by=["p"], order_by=["o"])


def test_rows_two_partition_and_order_keys(rng):
    """Two partition columns (hash_combine) and two order keys whose
    fields straddle the first 64-bit sort word."""
    cols, nulls = _table(rng, ties=True)
    cols["q"] = rng.integers(0, 3, N).astype(np.int64)
    cols["o2"] = rng.standard_normal(N)
    _check(cols, nulls, reds=("sum", "min", "count"), preceding=9,
           partition_by=["p", "q"], order_by=["o", "o2"])


@pytest.mark.parametrize("partitioned", [True, False])
def test_range_int_keys_with_ties(rng, partitioned):
    """RANGE frames end at the current sorted row, so tied order values
    must sort exactly as in the JAX package."""
    cols, nulls = _table(rng, ties=True)
    _check(cols, nulls, preceding=7, frame="range",
           partition_by=["p"] if partitioned else (), order_by=["o"])


@pytest.mark.parametrize("partitioned", [True, False])
def test_range_float32_keys(rng, partitioned):
    """Float keys subtract the delta in their own dtype."""
    cols, nulls = _table(rng, odtype=np.float32)
    cols["o"] = (rng.standard_normal(N) * 3).astype(np.float32)
    _check(cols, nulls, preceding=0.5, frame="range",
           partition_by=["p"] if partitioned else (), order_by=["o"])


@pytest.mark.parametrize("odtype", [np.int32, np.int64])
def test_range_int_keys_near_the_minimum(rng, odtype):
    """o - delta below the dtype's minimum: int32 keys clip, int64 keys
    wrap in both packages."""
    cols, nulls = _table(rng, odtype=odtype)
    cols["o"][:3] = [np.iinfo(odtype).min + 2, np.iinfo(odtype).min, 7]
    _check(cols, nulls, reds=("sum", "min", "count"), preceding=10,
           frame="range", partition_by=["p"], order_by=["o"])
    _check(cols, nulls, reds=("max", "avg"), preceding=2.5e9,
           frame="range", order_by=["o"])


def test_range_full_span_power_of_two():
    """n a power of two and a delta covering the whole partition: the
    per-row sparse-table level reaches log2(n)."""
    cols = {"o": np.arange(8, dtype=np.int32),
            "v": np.asarray([5, 1, 9, 4, 2, 8, 0, 3], np.float64)}
    _check(cols, reds=("min", "max"), preceding=100, frame="range",
           order_by=["o"])
    t = tops.window_function(make_tables(cols)[1], "v", "min",
                             preceding=100, order_by=["o"], frame="range")
    np.testing.assert_array_equal(np_of(t.data),
                                  np.minimum.accumulate(cols["v"]))


# frame -> window_function's frame arguments
FRAMES = {"running": dict(preceding=None), "rows": dict(preceding=5),
          "range": dict(preceding=30, frame="range")}


@pytest.mark.parametrize("vdtype", [np.float32, np.float64])
@pytest.mark.parametrize("frame", list(FRAMES))
def test_denormal_min_max(rng, vdtype, frame):
    """A denormal value is zero in every min / max frame (ROW running, ROW
    bounded, RANGE), as XLA's min / max read it."""
    cols, nulls = _table(rng, nparts=40, vdtype=vdtype)
    info = np.finfo(vdtype)
    d = vdtype(1e-40) if vdtype == np.float32 else vdtype(1e-310)
    cols["v"] = rng.choice(
        np.array([d, -d, 2 * d, info.smallest_subnormal, 0.0, -0.0, 1.0,
                  -1.0], vdtype), N, p=[.25, .25, .2, .1, .05, .05, .05, .05])
    _check(cols, nulls, reds=("min", "max"), partition_by=["p"],
           order_by=["o"], **FRAMES[frame])


def _first_in_order(cols, part):
    """Row index of partition `part`'s first row in window order."""
    rows = np.flatnonzero(cols["p"] == part)
    return rows[np.argmin(cols["o"][rows])]


@pytest.mark.parametrize("vdtype", [np.float64, np.float32])
@pytest.mark.parametrize("frame", ["running", "rows"])
@pytest.mark.parametrize("partitioned", [True, False])
def test_nan_min_max(rng, vdtype, frame, partitioned):
    """NaN and +-inf values with nulls: a valid NaN wins every min and max
    frame it is in, from there on in a running frame; a NULL NaN does not
    count. Partition 0's first row in order is a valid NaN, partition 1's a
    NULL one."""
    cols, nulls = _table(rng, vdtype=vdtype)
    v = cols["v"]
    v[rng.random(N) < 0.04] = np.nan
    v[rng.random(N) < 0.02] = np.inf
    v[rng.random(N) < 0.02] = -np.inf
    for part, null in ((0, False), (1, True)):
        first = _first_in_order(cols, part)
        v[first], nulls["v"][first] = np.nan, null
    _check(cols, nulls, reds=("min", "max"),
           partition_by=["p"] if partitioned else (), order_by=["o"],
           **FRAMES[frame])


@pytest.mark.parametrize("values", [
    [3.0, np.nan, 1.0, 2.0, -1.0],
    [3.0, np.nan, 1.0, 2.0, 1.0, -np.inf, np.inf]])
def test_running_min_propagates_nan(values):
    """float64 [3, NaN, 1, 2, -1] in order: running min 3 NaN NaN NaN NaN
    in both packages."""
    n = len(values)
    cols = {"o": np.arange(n, dtype=np.int32),
            "v": np.asarray(values, np.float64)}
    _check(cols, reds=("min", "max"), order_by=["o"])
    t = tops.window_function(make_tables(cols)[1], "v", "min",
                             order_by=["o"])
    np.testing.assert_array_equal(np_of(t.data),
                                  [3.0] + [np.nan] * (n - 1))


@pytest.mark.parametrize("kw,status", [
    (dict(reduction="median"), GDFStatus.GDF_INVALID_AGGREGATOR),
    (dict(preceding=-5, order_by=["o"], frame="range"),
     GDFStatus.GDF_INVALID_API_CALL),
    (dict(preceding=2, order_by=["o", "o2"], frame="range"),
     GDFStatus.GDF_INVALID_API_CALL),
    (dict(order_by=["o"], frame="range"), GDFStatus.GDF_INVALID_API_CALL),
    (dict(preceding=0, order_by=["o"]), GDFStatus.GDF_INVALID_API_CALL),
    (dict(frame="groups"), GDFStatus.GDF_INVALID_API_CALL),
])
def test_errors_match_jax(kw, status):
    cols = {"o": np.arange(4, dtype=np.int32),
            "o2": np.arange(4, dtype=np.int32),
            "v": np.arange(4, dtype=np.float64)}
    jt, tt = make_tables(cols)
    kw = dict(kw)
    red = kw.pop("reduction", "sum")
    with pytest.raises(GDFError) as got:
        tops.window_function(tt, "v", red, **kw)
    assert got.value.status == status
    with pytest.raises(Exception) as want:
        jops.window_function(jt, "v", red, **kw)
    assert want.value.status.value == status.value
