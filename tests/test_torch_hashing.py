"""libgdf_tpu_torch.ops.hashing against libgdf_tpu.ops.hashing, on the CPU.

Every hash, partition number, offset and row order must match bit for
bit: a row has to land in the same partition in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libgdf_tpu
import libgdf_tpu.ops.hashing as jh
from libgdf_tpu.compat import gdf as jgdf
from libgdf_tpu_torch import Column
from libgdf_tpu_torch.compat import gdf
from libgdf_tpu_torch.core import bits
from libgdf_tpu_torch.ops import hashing as th
from torch_parity import assert_tables_match, jax_op, make_tables, np_of

N = 257
_murmur3 = jax.jit(jh.murmur3_32)
_hash_columns = jax.jit(jh.hash_columns, static_argnames="hash_fn")
_fnv1a = jax.jit(jh.fnv1a_64_columns)


def _column(rng, dtype, n=N):
    """Values of `dtype` with the edge cases of its kind."""
    if np.issubdtype(dtype, np.floating):
        x = (rng.standard_normal(n) * 1e3).astype(dtype)
        edge = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf,
                np.finfo(dtype).tiny / 4, -np.finfo(dtype).tiny / 2,
                np.finfo(dtype).max, 1.0]
        x[:len(edge)] = np.asarray(edge, dtype)
        return x
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, n, endpoint=True).astype(dtype)
    x[:4] = [0, -1, info.min, info.max]
    return x


DTYPES = [np.int8, np.int16, np.int32, np.int64, np.float32, np.float64]


def _u32(h):
    """Hash values as uint32 (the port keeps them in int64)."""
    return np_of(h).astype(np.int64).astype(np.uint32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_murmur3_32_bit_exact(rng, dtype):
    x = _column(rng, dtype)
    want = np.asarray(_murmur3(jnp.asarray(x)))
    got = th.murmur3_32(torch.as_tensor(x))
    assert got.dtype == torch.int64 and int(got.min()) >= 0
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("dtype", DTYPES + [np.bool_, np.uint32])
def test_to_unsigned_bits_matches_jax(rng, dtype):
    from libgdf_tpu.core.bits import to_unsigned_bits
    x = (rng.random(N) < 0.5) if dtype is np.bool_ else (
        rng.integers(0, 2**32, N).astype(dtype) if dtype is np.uint32
        else _column(rng, dtype))
    want = np.asarray(to_unsigned_bits(jnp.asarray(x)))
    got = bits.to_unsigned_bits(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint64) if want.itemsize == 8
                                  else got.astype(want.dtype), want)
    if want.itemsize == 8:
        lo, hi = bits.u64_words(torch.as_tensor(got))
        np.testing.assert_array_equal(
            (hi.numpy().astype(np.uint64) << np.uint64(32))
            | lo.numpy().astype(np.uint64), want)


@pytest.mark.parametrize("hash_fn", ["murmur3", "identity"])
@pytest.mark.parametrize("ncols", [1, 2, 3])
def test_hash_columns(rng, hash_fn, ncols):
    dts = [np.int32, np.int64, np.int16] if hash_fn == "identity" else \
        [np.float64, np.int32, np.float32]
    cols = [_column(rng, d) for d in dts[:ncols]]
    want = np.asarray(_hash_columns([jnp.asarray(c) for c in cols],
                                    hash_fn=hash_fn))
    got = th.hash_columns([torch.as_tensor(c) for c in cols], hash_fn)
    np.testing.assert_array_equal(_u32(got), want)


# XLA's float -> uint32 convert saturates: NaN and x <= -1 give 0, x >= 2^32
# gives 2^32 - 1, the rest truncate toward zero
FLOAT_EDGES = [-1.0, -0.5, -0.0, 0.0, 0.5, 1.0, 2.7, -1.5, -2.5, 1e-40,
               np.inf, -np.inf, np.nan, 5e9, 3e9, 2.0 ** 31, 2.0 ** 32,
               2.0 ** 32 - 1, 4294967040.0, 4294967295.5, 123456.75, 1e300]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("entry", ["hash_columns", "partitions", "abi"])
def test_identity_hash_of_floats(rng, dtype, entry):
    """Float columns under the identity hash, through every entry that
    takes one: the row hash, partition ids and the partitioned table, and
    the ABI's gdf_hash / gdf_hash_partition (4294967040 is the largest
    float32 under 2^32; 2^32 - 1, 4294967295.5 and 1e300 round to 2^32
    and inf in float32)."""
    with np.errstate(over="ignore"):
        x = np.array(FLOAT_EDGES * 3, dtype)
    rng.shuffle(x)
    n = x.size
    a = rng.integers(-5, 5, n).astype(np.int32)
    if entry == "hash_columns":
        for cols in ([x], [a, x], [x, a]):
            want = _hash_columns([jnp.asarray(c) for c in cols],
                                 hash_fn="identity")
            got = th.hash_columns([torch.as_tensor(c) for c in cols],
                                  "identity")
            np.testing.assert_array_equal(_u32(got), np.asarray(want))
    elif entry == "partitions":
        jt, tt = make_tables({"a": a, "f": x}, {"f": rng.random(n) < 0.1})
        for keys in (("f",), ("a", "f")):
            for p in (4, 7):
                want = jax_op("partition_ids", jt, key_names=keys,
                              num_partitions=p, hash_fn="identity")
                got = th.partition_ids(tt, list(keys), p, "identity")
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        jout, joff = jax_op("hash_partition", jt, key_names=("f", "a"),
                            num_partitions=5, hash_fn="identity")
        tout, toff = th.hash_partition(tt, ["f", "a"], 5, "identity")
        np.testing.assert_array_equal(toff.numpy(), np.asarray(joff))
        assert_tables_match(jout, tout)
    else:
        ja, ta = (libgdf_tpu.Column.from_array(a),
                  Column.from_array(a, device="cpu"))
        jf, tf = (libgdf_tpu.Column.from_array(x),
                  Column.from_array(x, device="cpu"))
        want = jax.jit(lambda c, d: jgdf.gdf_hash(2, [c, d], "identity"))(
            jf, ja)
        got = gdf.gdf_hash(2, [tf, ta], "identity")
        np.testing.assert_array_equal(np_of(got.data), np_of(want.data))
        jcols, joffs = jax.jit(lambda c, d: jgdf.gdf_hash_partition(
            2, [c, d], [0], 4, "identity"))(jf, ja)
        tcols, toffs = gdf.gdf_hash_partition(2, [tf, ta], [0], 4,
                                              "identity")
        np.testing.assert_array_equal(np_of(toffs), np_of(joffs))
        for jc, tc in zip(jcols, tcols):
            np.testing.assert_array_equal(np_of(tc.data), np_of(jc.data))


def test_hash_combine_bit_exact(rng):
    a = rng.integers(0, 2**32, N).astype(np.uint32)
    b = rng.integers(0, 2**32, N).astype(np.uint32)
    want = np.asarray(jh.hash_combine(jnp.asarray(a), jnp.asarray(b)))
    got = th.hash_combine(torch.as_tensor(a.astype(np.int64)),
                          torch.as_tensor(b.astype(np.int64)))
    np.testing.assert_array_equal(_u32(got), want)


def test_fnv1a_64_columns(rng):
    cols = [_column(rng, np.int8), _column(rng, np.float32),
            _column(rng, np.int64), _column(rng, np.float64)]
    want = np.asarray(_fnv1a([jnp.asarray(c) for c in cols]))
    got = th.fnv1a_64_columns([torch.as_tensor(c) for c in cols])
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


def _table_data(rng, n=N):
    cols = {"a": rng.integers(-50, 50, n).astype(np.int32),
            "b": _column(rng, np.float64, n),
            "c": rng.integers(-2**40, 2**40, n).astype(np.int64)}
    nulls = {"b": rng.random(n) < 0.2, "c": rng.random(n) < 0.1}
    return cols, nulls


@pytest.mark.parametrize("hash_fn", ["murmur3", "identity"])
def test_hash_table_rows_and_partition_ids(rng, hash_fn):
    cols, nulls = _table_data(rng)
    if hash_fn == "identity":
        cols["b"] = rng.integers(0, 99, N).astype(np.float64)
    jt, tt = make_tables(cols, nulls)
    for k in (0, 2):
        want = jax_op("hash_table_rows", jt, num_columns_to_hash=k,
                      hash_fn=hash_fn)
        got = th.hash_table_rows(tt, k, hash_fn)
        assert got.data.dtype == torch.int32 and got.name == want.name
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    for p in (1, 7, 64):
        want = jax_op("partition_ids", jt, key_names=("a", "b"),
                      num_partitions=p, hash_fn=hash_fn)
        got = th.partition_ids(tt, ["a", "b"], p, hash_fn)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("num_rows", [None, 0, 100])
@pytest.mark.parametrize("nparts", [1, 5, 16])
def test_hash_partition(rng, num_rows, nparts):
    cols, nulls = _table_data(rng)
    jt, tt = make_tables(cols, nulls, num_rows=num_rows)
    jout, joff = jax_op("hash_partition", jt, key_names=("a", "c"),
                        num_partitions=nparts)
    tout, toff = th.hash_partition(tt, ["a", "c"], nparts)
    assert toff.dtype == torch.int32
    np.testing.assert_array_equal(toff.numpy(), np.asarray(joff))
    assert_tables_match(jout, tout)


@pytest.mark.parametrize("live", [False, True])
def test_partition_sizes(rng, live):
    ids = rng.integers(0, 9, N).astype(np.int32)
    mask = rng.random(N) < 0.7 if live else None
    want = np.asarray(jh.partition_sizes(
        jnp.asarray(ids), 9, None if mask is None else jnp.asarray(mask)))
    got = th.partition_sizes(torch.as_tensor(ids), 9,
                             None if mask is None else torch.as_tensor(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
