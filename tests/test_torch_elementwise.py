"""libgdf_tpu_torch elementwise ops against libgdf_tpu's, on the CPU.

The same numpy columns go through both packages. Integers, casts, output
dtypes and null masks are exact; unary math is held to rtol 1e-6 at float32
and 1e-12 at float64. The cases where `jnp` and `torch` answer differently
for the same call (division by zero, `div` on integers, float -> integer
casts out of range, mixed dtypes) each have their own test.

Denormal floats: a denormal is zero, as on the TPU (XLA flushes them, on
the CPU too). The port flushes the inputs of the comparisons, float <->
float casts, division, floor-division, sqrt / floor / ceil / log and
min / max, each input in its own dtype before any promotion, and the
denormal tests hold each to the JAX package on columns of zeros,
+-denormals and finfo.tiny, against the same dtype, the other float dtype
and int32 / int64 columns, both ways round (and the ABI's typed and
generic comparisons). add / sub / mul, the float sums and every result
that is itself denormal are left out on purpose: there the port keeps
torch's denormals, which differ from a zero and change no row set.
"""
import itertools

import jax
import numpy as np
import pytest

import libgdf_tpu
from libgdf_tpu import ops as jops
from libgdf_tpu.compat import gdf as jgdf
from libgdf_tpu_torch import Column, GDFDtype, TimeUnit, ops
from libgdf_tpu_torch.compat import gdf
from torch_parity import np_of

DTYPES = (np.int8, np.int32, np.int64, np.float32, np.float64)
UNARY = ("sin", "cos", "tan", "asin", "acos", "atan", "exp", "log", "sqrt",
         "ceil", "floor")
ARITH = ("add", "sub", "mul", "div", "floordiv")
CMP = ("gt", "ge", "lt", "le", "eq", "ne")
BITWISE = ("bitwise_and", "bitwise_or", "bitwise_xor")


def both(values, null=None, **kw):
    """The same column in both packages (the port's on the CPU)."""
    jkw = {k: (getattr(libgdf_tpu.GDFDtype, v.name) if k == "gdf_dtype"
               else getattr(libgdf_tpu.TimeUnit, v.name))
           for k, v in kw.items()}
    if null is None:
        return (libgdf_tpu.Column.from_array(values, **jkw),
                Column.from_array(values, device="cpu", **kw))
    return (libgdf_tpu.Column.from_array(values, valid=~null, **jkw),
            Column.from_array(values, valid=~null, device="cpu", **kw))


def assert_same_column(jc, tc, rtol=None):
    """Logical dtype, time unit, physical dtype, validity, and the values
    of the valid rows (exact, or to rtol; NaN equals NaN)."""
    assert tc.info.gdf_dtype.value == jc.info.gdf_dtype.value
    assert tc.info.time_unit.value == jc.info.time_unit.value
    jv, tv = np_of(jc.data), np_of(tc.data)
    assert tv.dtype == jv.dtype
    assert (tc.valid is None) == (jc.valid is None)
    ok = np.ones(jv.shape, bool)
    if jc.valid is not None:
        np.testing.assert_array_equal(np_of(tc.valid), np_of(jc.valid))
        ok = np_of(jc.valid)
    if rtol is None:
        np.testing.assert_array_equal(tv[ok], jv[ok])
    else:
        np.testing.assert_allclose(tv[ok], jv[ok], rtol=rtol, atol=0)


def jbinary(a, b, op):
    return jax.jit(lambda x, y: jops.binary_op(x, y, op))(a, b)


@pytest.mark.parametrize("op", UNARY)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_unary_math(op, dtype, rng):
    x = rng.random(100).astype(dtype) * 0.9 + 0.05
    null = rng.random(100) < 0.2
    jc, tc = both(x, null)
    want = jax.jit(lambda c: jops.unary_op(c, op))(jc)
    assert_same_column(want, ops.unary_op(tc, op),
                       rtol=1e-6 if dtype == np.float32 else 1e-12)
    assert_same_column(want, getattr(ops, op)(tc),
                       rtol=1e-6 if dtype == np.float32 else 1e-12)


def test_unary_rejects_integers_and_unknown_ops():
    _, tc = both(np.arange(4, dtype=np.int32))
    with pytest.raises(ops.elementwise.GDFError):
        ops.unary_op(tc, "sin")
    _, tf = both(np.ones(4, np.float32))
    with pytest.raises(ops.elementwise.GDFError):
        ops.unary_op(tf, "sinh")


@pytest.mark.parametrize("op", ARITH)
def test_binary_arith(op, rng):
    a = rng.integers(1, 100, 200).astype(np.int32)
    b = rng.integers(1, 100, 200).astype(np.int32)
    (ja, ta), (jb, tb) = both(a), both(b)
    assert_same_column(jbinary(ja, jb, op), ops.binary_op(ta, tb, op),
                       rtol=1e-6 if op == "div" else None)
    assert_same_column(jbinary(ja, jb, op), getattr(ops, op)(ta, tb),
                       rtol=1e-6 if op == "div" else None)


def test_binary_null_propagation(rng):
    n = 100
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    (ja, ta) = both(a, rng.random(n) < 0.3)
    (jb, tb) = both(b, rng.random(n) < 0.3)
    assert_same_column(jbinary(ja, jb, "add"), ops.add(ta, tb))
    # one side without a mask: the other's mask passes through
    (jc, tc) = both(b)
    assert_same_column(jbinary(ja, jc, "mul"), ops.mul(ta, tc))


@pytest.mark.parametrize("op", CMP)
def test_comparisons_int8_output(op, rng):
    a = rng.integers(0, 10, 100).astype(np.int64)
    b = rng.integers(0, 10, 100).astype(np.int64)
    (ja, ta), (jb, tb) = both(a), both(b)
    out = getattr(ops, op)(ta, tb)
    assert out.gdf_dtype == GDFDtype.INT8
    assert_same_column(jbinary(ja, jb, op), out)


def test_bitwise(rng):
    a = rng.integers(-(1 << 20), 1 << 20, 100).astype(np.int32)
    b = rng.integers(-(1 << 20), 1 << 20, 100).astype(np.int32)
    (ja, ta), (jb, tb) = both(a), both(b)
    for op in BITWISE:
        assert_same_column(jbinary(ja, jb, op), getattr(ops, op)(ta, tb))


def test_unknown_binop_and_size_mismatch():
    _, ta = both(np.arange(4, dtype=np.int32))
    _, tb = both(np.arange(5, dtype=np.int32))
    with pytest.raises(ops.elementwise.GDFError):
        ops.binary_op(ta, ta, "pow")
    with pytest.raises(ops.elementwise.GDFError):
        ops.binary_op(ta, tb, "add")


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.int64])
def test_integer_floordiv_by_zero_and_overflow(dtype):
    """XLA's integer division: x // 0 is -1 for x == 0 and -2 otherwise,
    and INT_MIN // -1 wraps. torch raises on the CPU."""
    lo, hi = np.iinfo(dtype).min, np.iinfo(dtype).max
    a = np.array([5, -5, 0, lo, hi, lo, hi, 7, -7, lo, 1], dtype)
    b = np.array([0, 0, 0, 0, 0, -1, -1, 2, 2, 1, -1], dtype)
    (ja, ta), (jb, tb) = both(a), both(b)
    want = jbinary(ja, jb, "floordiv")
    assert np_of(want.data)[:3].tolist() == [-2, -2, -1]
    assert_same_column(want, ops.floordiv(ta, tb))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_float_floordiv_by_zero_is_nan(dtype):
    a = np.array([5., -5., 0., 7.5, -7.5, np.inf, 1., np.nan, 6.], dtype)
    b = np.array([0., 0., 0., 2., 2., 3., np.inf, 1., -0.], dtype)
    (ja, ta), (jb, tb) = both(a), both(b)
    want = jbinary(ja, jb, "floordiv")
    assert np.isnan(np_of(want.data)[:2]).all()
    assert_same_column(want, ops.floordiv(ta, tb))


def test_float_floordiv_random(rng):
    a = (rng.standard_normal(500) * 100).astype(np.float64)
    b = (rng.standard_normal(500) * 7).astype(np.float64)
    (ja, ta), (jb, tb) = both(a), both(b)
    assert_same_column(jbinary(ja, jb, "floordiv"), ops.floordiv(ta, tb))


def test_div_on_integers_picks_jax_float_width(rng):
    """int32 / int32 is FLOAT32 and int64 / int64 FLOAT64, as jnp.divide;
    torch.true_divide gives float32 for int64."""
    for dtype, want in ((np.int8, GDFDtype.FLOAT32),
                        (np.int32, GDFDtype.FLOAT32),
                        (np.int64, GDFDtype.FLOAT64)):
        a = rng.integers(-100, 100, 50).astype(dtype)
        b = rng.integers(1, 100, 50).astype(dtype)
        (ja, ta), (jb, tb) = both(a), both(b)
        out = ops.div(ta, tb)
        assert out.gdf_dtype == want
        assert_same_column(jbinary(ja, jb, "div"), out, rtol=1e-6)
    # division by zero: inf / nan in both
    (ja, ta) = both(np.array([1, -1, 0], np.int64))
    (jb, tb) = both(np.zeros(3, np.int64))
    assert_same_column(jbinary(ja, jb, "div"), ops.div(ta, tb))


@pytest.mark.parametrize("da,db", list(itertools.product(DTYPES, DTYPES)))
def test_mixed_dtype_promotion(da, db, rng):
    """Every pair of {int8, int32, int64, float32, float64}: the output
    dtype and values of arithmetic and comparisons follow jnp's lattice."""
    a = rng.integers(-50, 50, 64).astype(da)
    b = rng.integers(1, 50, 64).astype(db)
    (ja, ta), (jb, tb) = both(a), both(b)
    for op in ARITH + CMP:
        assert_same_column(jbinary(ja, jb, op), ops.binary_op(ta, tb, op),
                           rtol=1e-6 if op == "div" else None)
    jcmp = jax.jit(lambda x, y: jops.compare(x, y, "le"))(ja, jb)
    assert_same_column(jcmp, ops.compare(ta, tb, "le"))
    if np.issubdtype(da, np.integer) and np.issubdtype(db, np.integer):
        for op in BITWISE:
            assert_same_column(jbinary(ja, jb, op),
                               ops.binary_op(ta, tb, op))


def test_compare_scalar_stencil(rng):
    a = rng.integers(0, 100, 100).astype(np.int32)
    ja, ta = both(a, rng.random(100) < 0.2)
    for op in (4, "gt", "eq", 1):
        want = jax.jit(lambda c: jops.compare_scalar(c, 50, op))(ja)
        assert_same_column(want, ops.compare_scalar(ta, 50, op))


INT_TARGETS = (GDFDtype.INT8, GDFDtype.INT16, GDFDtype.INT32, GDFDtype.INT64,
               GDFDtype.DATE32, GDFDtype.DATE64, GDFDtype.TIMESTAMP)


@pytest.mark.parametrize("src", [np.float32, np.float64])
@pytest.mark.parametrize("to", INT_TARGETS, ids=lambda t: t.name)
def test_float_to_integer_cast_saturates(src, to):
    """XLA's convert: NaN -> 0, out of range -> the nearest end of the
    target's range, otherwise truncation towards zero."""
    x = np.array([np.nan, np.inf, -np.inf, 3e10, -3e10, 300.7, -300.7,
                  127.0, 127.5, 128.0, -128.0, -128.5, -129.0, 0.5, -0.5,
                  2147483520.0, 2147483648.0, -2147483648.0, -2147483904.0,
                  9.2e18, 9.3e18, -9.2e18, -9.3e18, 1e38, -1e38,
                  32767.0, 32768.0, -32768.0, -32769.0, 0.0, -0.0], src)
    jc, tc = both(x)
    jto = getattr(libgdf_tpu.GDFDtype, to.name)
    want = jax.jit(lambda c: jops.cast(c, jto))(jc)
    assert_same_column(want, ops.cast(tc, to))


def test_float32_to_int32_and_int8_documented_values():
    x = np.array([np.nan, np.inf, -np.inf, 3e10, 300.7], np.float32)
    _, tc = both(x)
    assert np_of(ops.cast(tc, GDFDtype.INT32).data).tolist() == \
        [0, 2147483647, -2147483648, 2147483647, 300]
    assert np_of(ops.cast(tc, GDFDtype.INT8).data).tolist() == \
        [0, 127, -128, 127, 127]


ALL_NUMERIC = (GDFDtype.INT8, GDFDtype.INT16, GDFDtype.INT32, GDFDtype.INT64,
               GDFDtype.FLOAT32, GDFDtype.FLOAT64)
_NP = {GDFDtype.INT8: np.int8, GDFDtype.INT16: np.int16,
       GDFDtype.INT32: np.int32, GDFDtype.INT64: np.int64,
       GDFDtype.FLOAT32: np.float32, GDFDtype.FLOAT64: np.float64}


@pytest.mark.parametrize("src", ALL_NUMERIC, ids=lambda t: t.name)
def test_cast_numeric_matrix(src, rng):
    x = (rng.standard_normal(64) * 100).astype(_NP[src])
    jc, tc = both(x, rng.random(64) < 0.2)
    for to in ALL_NUMERIC + (GDFDtype.DATE32, GDFDtype.DATE64):
        jto = getattr(libgdf_tpu.GDFDtype, to.name)
        want = jax.jit(lambda c: jops.cast(c, jto))(jc)
        assert_same_column(want, ops.cast(tc, to))


def test_integer_narrowing_cast_wraps():
    x = np.array([300, -300, 1 << 40, -(1 << 40), 127, 128], np.int64)
    jc, tc = both(x)
    for to in (GDFDtype.INT8, GDFDtype.INT16, GDFDtype.INT32):
        jto = getattr(libgdf_tpu.GDFDtype, to.name)
        assert_same_column(jax.jit(lambda c: jops.cast(c, jto))(jc),
                           ops.cast(tc, to))


def test_cast_date32_date64_scaling():
    days = np.asarray([0, 1, -1, 17897, -25567], np.int32)
    jc, tc = both(days, gdf_dtype=GDFDtype.DATE32)
    jout = jops.cast(jc, libgdf_tpu.GDFDtype.DATE64)
    tout = ops.cast(tc, GDFDtype.DATE64)
    assert_same_column(jout, tout)
    np.testing.assert_array_equal(np_of(tout.data),
                                  days.astype(np.int64) * 86400000)
    assert_same_column(jops.cast(jout, libgdf_tpu.GDFDtype.DATE32),
                       ops.cast(tout, GDFDtype.DATE32))


UNITS = (TimeUnit.s, TimeUnit.ms, TimeUnit.us, TimeUnit.ns)


@pytest.mark.parametrize("src", UNITS, ids=lambda u: u.name)
def test_cast_timestamp_units_floor_before_1970(src):
    """Datetime -> datetime down-casts floor, pre-1970 values included."""
    t = np.asarray([1528935590123, -1000, -1, -999, -1001, 0, 86399999,
                    -86400001], np.int64)
    jc, tc = both(t, gdf_dtype=GDFDtype.TIMESTAMP, time_unit=src)
    for dst in UNITS:
        jdst = getattr(libgdf_tpu.TimeUnit, dst.name)
        assert_same_column(
            jops.cast(jc, libgdf_tpu.GDFDtype.TIMESTAMP, jdst),
            ops.cast(tc, GDFDtype.TIMESTAMP, dst))
    for to in (GDFDtype.DATE32, GDFDtype.DATE64):
        assert_same_column(
            jops.cast(jc, getattr(libgdf_tpu.GDFDtype, to.name)),
            ops.cast(tc, to))


def _denormal_columns(dtype):
    """Zeros, +-denormals, +-finfo.tiny and normal values, and a second
    column that meets them in every order."""
    den = dtype(1e-40) if dtype == np.float32 else dtype(1e-310)
    tiny = np.finfo(dtype).tiny
    x = np.array([0.0, -0.0, den, -den, tiny, 1.5, -tiny, 2 * den, -1.5,
                  den], dtype)
    y = np.array([0.0, den, -0.0, den, -den, 1.5, tiny, den, -den, -0.0],
                 dtype)
    return x, y


def _partners(dtype):
    """The columns a denormal column of `dtype` meets in a binary op: its
    own dtype's second column, both of the other float dtype's, and int32
    and int64 columns with zeros (chosen so that no quotient is itself
    denormal)."""
    _, y = _denormal_columns(dtype)
    other = np.float64 if dtype == np.float32 else np.float32
    ints = np.array([0, 1, -1, 0, 1, 3, -1, -2, 5, 0])
    return (y, *_denormal_columns(other), ints.astype(np.int32),
            ints.astype(np.int64))


def _both_ways(x):
    """(JAX, port) column pairs (x, p) and (p, x) for every partner p of
    the denormal column x."""
    jx, tx = both(x)
    for p in _partners(x.dtype.type):
        jp, tp = both(p)
        yield (jx, tx), (jp, tp)
        yield (jp, tp), (jx, tx)


def _same_bits(jc, tc):
    """Values exact with the sign of zero; NaN equals NaN."""
    assert_same_column(jc, tc)
    jv, tv = np_of(jc.data), np_of(tc.data)
    ok = ~np.isnan(jv)
    np.testing.assert_array_equal(np.signbit(tv[ok]), np.signbit(jv[ok]))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("op", CMP)
def test_denormal_compares_match_jax(dtype, op):
    x, y = _denormal_columns(dtype)
    (jx, tx), (jy, ty) = both(x), both(y)
    for value in (0.0, -0.0, float(x[2]), 1e-39):
        want = jax.jit(lambda c: jops.compare_scalar(c, value, op))(jx)
        assert_same_column(want, ops.compare_scalar(tx, value, op))
    want = jax.jit(lambda a, b: jops.compare(a, b, op))(jx, jy)
    assert_same_column(want, ops.compare(tx, ty, op))
    for (ja, ta), (jb, tb) in _both_ways(x):
        assert_same_column(jbinary(ja, jb, op), ops.binary_op(ta, tb, op))
    sfx = "f32" if dtype == np.float32 else "f64"
    for name in (f"gdf_{op}_{sfx}", f"gdf_{op}_generic"):
        assert_same_column(jax.jit(getattr(jgdf, name))(jx, jy),
                           getattr(gdf, name)(tx, ty))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_denormal_unary_floordiv_and_casts_match_jax(dtype):
    x, y = _denormal_columns(dtype)
    (jx, tx), (jy, ty) = both(x), both(y)
    for op in ("sqrt", "floor", "ceil", "log"):
        _same_bits(jax.jit(lambda c: jops.unary_op(c, op))(jx),
                   ops.unary_op(tx, op))
    for (ja, ta), (jb, tb) in _both_ways(x):
        for op in ("div", "floordiv"):
            _same_bits(jbinary(ja, jb, op), ops.binary_op(ta, tb, op))
    to = "FLOAT64" if dtype == np.float32 else "FLOAT32"
    _same_bits(jax.jit(lambda c: jops.cast(
        c, getattr(libgdf_tpu.GDFDtype, to)))(jx),
        ops.cast(tx, getattr(GDFDtype, to)))
    # a float64 value that is a denormal only as float32
    w = np.array([1e-39, -1e-39, 1e-45, 2e-38], np.float64)
    jw, tw = both(w)
    _same_bits(jax.jit(lambda c: jops.cast(
        c, libgdf_tpu.GDFDtype.FLOAT32))(jw), ops.cast(tw, GDFDtype.FLOAT32))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rows", [
    (2, 5), (3, 5), (0, 3, 5), (1, 2), (2, 3), (3, 2), (3, 1, 8), (0, 1),
    (1, 0), (3, 0), (2, 1)])
def test_denormal_min_max_match_jax(dtype, rows):
    """min / max over zeros and denormals, the sign of a zero result
    included (XLA orders -0.0 below +0.0)."""
    x, _ = _denormal_columns(dtype)
    jc, tc = both(x[list(rows)])
    for op in ("min", "max"):
        want = np_of(jax.jit(getattr(jops.reductions, op))(jc))
        got = np_of(getattr(ops.reductions, op)(tc))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert np.signbit(got) == np.signbit(want), (op, rows)
