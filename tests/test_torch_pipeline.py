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
    again = tops.order_by(from_numpy(values, nulls), ["s"], ascending=False,
                          nulls_last=True)
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
