"""Prefix sums, reductions, quantiles and sorted searches of
libgdf_tpu_torch against libgdf_tpu, on the CPU.

Tolerances: integer results, dtypes, positions and quantiles exact (the
same sort and the same float64 arithmetic on both sides); float32 prefix
sums within 2e-4 of the running sum of |x|, float16 ones within 5e-3 of it
(the JAX package accumulates float16 in float16, the port in float32);
float32 reductions rtol=1e-5 with atol=1e-5 * sum|x|, float64 ones
rtol=1e-12 (another summation order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libgdf_tpu
import libgdf_tpu.ops as jops
from libgdf_tpu.ops import engine as jengine
from libgdf_tpu.ops import sorted_search as jss
from libgdf_tpu_torch import Column
from libgdf_tpu_torch import ops as tops
from libgdf_tpu_torch.core.errors import GDFError, GDFStatus
from libgdf_tpu_torch.ops import engine as tengine
from libgdf_tpu_torch.ops import sorted_search as tss
from torch_parity import jax_op, np_of

N = 2000


def _columns(x, null=None):
    jc = libgdf_tpu.Column.from_array(x, valid=None if null is None
                                      else ~null)
    tc = Column.from_masked(x, null, device="cpu")
    return jc, tc


def _ints(rng, dtype, n=N):
    info = np.iinfo(dtype)
    lo, hi = (-2**62, 2**62) if dtype == np.int64 else (info.min, info.max)
    return rng.integers(lo, hi, n, endpoint=True).astype(dtype)


# -- prefixsum -------------------------------------------------------------

@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.int64])
def test_prefixsum_integers_exact(rng, dtype, inclusive):
    """Sums wrap in the column's dtype, in both packages."""
    x = _ints(rng, dtype)
    jc, tc = _columns(x)
    want = jax_op("prefixsum", jc, inclusive=inclusive)
    got = tops.prefixsum(tc, inclusive)
    assert got.data.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(np_of(got.data), np.asarray(want.data))
    assert got.info == tc.info and got.name == tc.name


@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_prefixsum_floats(rng, dtype, inclusive):
    x = (rng.standard_normal(N) * np.exp(rng.uniform(-5, 5, N))).astype(dtype)
    jc, tc = _columns(x)
    want = np.asarray(jax_op("prefixsum", jc, inclusive=inclusive).data)
    got = np_of(tops.prefixsum(tc, inclusive).data)
    assert got.dtype == want.dtype == dtype
    rel = 2e-4 if dtype == np.float32 else 1e-12
    bound = rel * np.cumsum(np.abs(x.astype(np.float64))) + rel
    if not inclusive:
        bound = np.concatenate([[rel], bound[:-1]])
    assert (np.abs(got.astype(np.float64) - want) <= bound).all()


def test_cumsum_float16_runs_at_float32(rng):
    """float16 has no H2 instance: engine.cumsum runs it at float32 and
    rounds back, as the JAX package's routing does on the TPU."""
    x = rng.standard_normal(500).astype(np.float16)
    want = np.asarray(jax.jit(jengine.cumsum)(jnp.asarray(x)))
    got = tengine.cumsum(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.float16
    np.testing.assert_array_equal(
        got, torch.cumsum(torch.from_numpy(x).float(), 0).half().numpy())
    bound = 5e-3 * np.cumsum(np.abs(x.astype(np.float64))) + 5e-3
    assert (np.abs(got.astype(np.float64) - want) <= bound).all()


def test_prefixsum_rejects_a_masked_column():
    _, tc = _columns(np.arange(4, dtype=np.int32),
                     np.array([0, 1, 0, 0], bool))
    with pytest.raises(GDFError) as e:
        tops.prefixsum(tc)
    assert e.value.status == GDFStatus.GDF_VALIDITY_UNSUPPORTED


def test_exclusive_prefixsum_of_an_empty_column_is_empty():
    """The JAX package returns one zero here (a length-1 column for an
    empty input); the port keeps the column's length."""
    _, tc = _columns(np.zeros(0, np.int64))
    assert tops.prefixsum(tc, inclusive=False).data.shape == (0,)


# -- reductions -------------------------------------------------------------

OPS = ("sum", "min", "max", "product", "sum_squared")


@functools.lru_cache(maxsize=None)
def _jax_reductions():
    return jax.jit(lambda c: [jops.reduce(c, op) for op in OPS])


@pytest.mark.parametrize("with_nulls", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32,
                                   np.float64])
def test_reduce_every_op(rng, dtype, with_nulls):
    if np.issubdtype(dtype, np.integer):
        x = rng.integers(-3, 4, N).astype(dtype)
        x[:5] = [np.iinfo(dtype).max, np.iinfo(dtype).min, 7, -9, 11]
    else:
        x = (1 + 0.01 * rng.standard_normal(N)).astype(dtype)
        x[:3] = [-5.5, 1e3, 0.25]
    null = rng.random(N) < 0.2 if with_nulls else None
    jc, tc = _columns(x, null)
    wants = _jax_reductions()(jc)
    for op, want in zip(OPS, wants):
        got = tops.reduce(tc, op)
        want = np.asarray(want)
        assert got.dim() == 0 and np_of(got).dtype == want.dtype, op
        if np.issubdtype(dtype, np.integer) or op in ("min", "max"):
            assert np_of(got) == want, op
        else:
            rtol = 1e-5 if dtype == np.float32 else 1e-12
            scale = np.abs(x.astype(np.float64)).sum()
            np.testing.assert_allclose(np_of(got), want, rtol=rtol,
                                       atol=rtol * scale, err_msg=op)
    assert tops.sum(tc) == tops.reduce(tc, "sum")
    assert tops.sum_of_squares(tc) == tops.reduce(tc, "sum_squared")
    assert tops.min(tc) == tops.reduce(tc, "min")
    assert tops.max(tc) == tops.reduce(tc, "max")
    assert tops.reductions.GDF_REDUCE_OPTIMAL_OUTPUT_SIZE == \
        jops.reductions.GDF_REDUCE_OPTIMAL_OUTPUT_SIZE


def test_reduce_rejects_an_unknown_op():
    _, tc = _columns(np.arange(3, dtype=np.int32))
    with pytest.raises(GDFError) as e:
        tops.reduce(tc, "mean")
    assert e.value.status == GDFStatus.GDF_INVALID_AGGREGATOR


# -- quantiles --------------------------------------------------------------

METHODS = ("linear", "lower", "higher", "midpoint", "nearest")
QS = (0.0, 0.25, 0.5, 0.9, 1.0)


@functools.lru_cache(maxsize=None)
def _jax_quantiles():
    return jax.jit(lambda c: [[jops.quantile_exact(c, q, m) for m in METHODS]
                              + [jops.quantile_approx(c, q)] for q in QS])


@pytest.mark.parametrize("with_nulls", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32])
def test_quantiles_exact(rng, dtype, with_nulls):
    n = 301
    x = (rng.standard_normal(n) * 100).astype(dtype)
    x[:20] = x[20:40]                      # ties
    null = rng.random(n) < 0.3 if with_nulls else None
    jc, tc = _columns(x, null)
    for q, wants in zip(QS, _jax_quantiles()(jc)):
        for m, want in zip(METHODS, wants):
            got = tops.quantile_exact(tc, q, m)
            assert got.dim() == 0 and got.dtype == torch.float64
            assert np_of(got) == np.asarray(want), (q, m)
        got = tops.quantile_approx(tc, q)
        assert np_of(got).dtype == x.dtype
        assert np_of(got) == np.asarray(wants[-1]), q


def test_quantile_errors():
    _, tc = _columns(np.arange(4.0))
    for kw in (dict(q=0.5, method="median"), dict(q=1.5)):
        with pytest.raises(GDFError) as e:
            tops.quantile_exact(tc, **kw)
        assert e.value.status == GDFStatus.GDF_INVALID_API_CALL


# -- sorted searches --------------------------------------------------------

def _sorted_keys(rng, n, nkeys, dtype=np.int32):
    keys = [rng.integers(-6, 6, n).astype(dtype) for _ in range(nkeys)]
    order = np.lexsort(keys[::-1])
    return [k[order] for k in keys]


@functools.lru_cache(maxsize=None)
def _jax_lex(side):
    return jax.jit(lambda s, q: jops.lex_searchsorted(s, q, side))


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("nkeys", [1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 200])
def test_lex_searchsorted(rng, side, nkeys, n):
    dtype = np.int64 if nkeys == 2 else np.int32
    skeys = _sorted_keys(rng, n, nkeys, dtype)
    qkeys = [rng.integers(-8, 8, 97).astype(dtype) for _ in range(nkeys)]
    got = tops.lex_searchsorted([torch.from_numpy(k) for k in skeys],
                                [torch.from_numpy(k) for k in qkeys], side)
    assert got.dtype == torch.int32
    if n:
        want = _jax_lex(side)([jnp.asarray(k) for k in skeys],
                              [jnp.asarray(k) for k in qkeys])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if nkeys == 1:
        np.testing.assert_array_equal(
            got.numpy(), np.searchsorted(skeys[0], qkeys[0], side))


_jax_merge = jax.jit(jss.merge_match_ranges)


@pytest.mark.parametrize("nkeys", [1, 2])
@pytest.mark.parametrize("n,m", [(150, 90), (40, 300), (1, 5)])
def test_sorted_search_bounds_and_match_ranges(rng, nkeys, n, m):
    skeys = _sorted_keys(rng, n, nkeys)
    qkeys = [rng.integers(-8, 8, m).astype(np.int32) for _ in range(nkeys)]
    t = [torch.from_numpy(k) for k in skeys]
    q = [torch.from_numpy(k) for k in qkeys]
    lower, upper = tss.sorted_search_bounds(t, q)
    for side, got in (("left", lower), ("right", upper)):
        np.testing.assert_array_equal(
            got.numpy(), tops.lex_searchsorted(t, q, side).numpy())
    # an unsorted build side: its permutation too, against the JAX package
    perm = rng.permutation(n)
    bkeys = [k[perm] for k in skeys]
    want = _jax_merge([jnp.asarray(k) for k in bkeys],
                      [jnp.asarray(k) for k in qkeys])
    got = tss.merge_match_ranges([torch.from_numpy(k) for k in bkeys], q)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
