"""libgdf_tpu_torch radix sorts, key_operands and compaction_indices against
libgdf_tpu's, on the CPU. Everything is exact: sorted keys, the values'
order (so ties are broken alike), the permutation of the dropped rows."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libgdf_tpu
from libgdf_tpu import ops as jops
from libgdf_tpu.ops import compaction as jcompaction
from libgdf_tpu.ops import sort as jsort
from libgdf_tpu_torch import Column, ops
from libgdf_tpu_torch.ops import compaction, sort
from torch_parity import assert_tables_match, make_tables, np_of

KEY_DTYPES = (np.int8, np.int16, np.int32, np.int64, np.float32, np.float64)


def make_keys(rng, dtype, n, few=False):
    if np.issubdtype(dtype, np.floating):
        k = (rng.standard_normal(n) * 100).astype(dtype)
        k[:8] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 1.5]
        return rng.permutation(k)
    info = np.iinfo(dtype)
    if few:
        return rng.integers(-5, 5, n).astype(dtype)
    return rng.integers(info.min, info.max, n, endpoint=True,
                        dtype=np.int64).astype(dtype)


@functools.lru_cache(maxsize=None)
def _jradix(descending, begin_bit, end_bit):
    return jax.jit(lambda k, v: jops.radixsort(
        k, v, descending=descending, begin_bit=begin_bit, end_bit=end_bit))


def check_radixsort(keys, descending=False, begin_bit=0, end_bit=None):
    n = keys.size
    vals = np.arange(n, dtype=np.int64)
    jk, jv = _jradix(descending, begin_bit, end_bit)(
        libgdf_tpu.Column.from_array(keys),
        libgdf_tpu.Column.from_array(vals))
    tk, tv = ops.radixsort(Column.from_array(keys, device="cpu"),
                           Column.from_array(vals, device="cpu"),
                           descending=descending, begin_bit=begin_bit,
                           end_bit=end_bit)
    assert np_of(tk.data).dtype == keys.dtype
    np.testing.assert_array_equal(np_of(tv.data), np_of(jv.data))
    np.testing.assert_array_equal(np_of(tk.data), np_of(jk.data))
    return np_of(tv.data)


@pytest.mark.parametrize("dtype", KEY_DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("descending", [False, True])
def test_radixsort_full_range(dtype, descending, rng):
    order = check_radixsort(make_keys(rng, dtype, 1000), descending)
    assert sorted(order.tolist()) == list(range(1000))


@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.int64])
@pytest.mark.parametrize("descending", [False, True])
def test_radixsort_is_stable_on_ties(dtype, descending, rng):
    """Equal keys keep their input order in both directions."""
    keys = make_keys(rng, dtype, 500, few=True)
    order = check_radixsort(keys, descending)
    for k in np.unique(keys):
        run = order[keys[order] == k]
        assert (np.diff(run) > 0).all()


# (key dtype, [(begin_bit, end_bit), ...]) at 8-, 32- and 64-bit keys
BIT_RANGES = [
    (np.int8, [(0, 4), (4, 8), (2, 6), (7, 8), (0, 8)]),
    (np.int32, [(8, 24), (0, 16), (16, 32), (31, 32), (8, None), (0, 32)]),
    (np.float32, [(8, 24), (23, 31), (31, 32)]),
    (np.int64, [(8, 24), (32, 64), (0, 32), (63, 64), (1, 64), (0, 63),
                (0, 64)]),
    (np.float64, [(52, 63), (63, 64), (0, 52)]),
]


@pytest.mark.parametrize("dtype,ranges", BIT_RANGES,
                         ids=lambda x: np.dtype(x).name
                         if isinstance(x, type) else "")
@pytest.mark.parametrize("descending", [False, True])
def test_radixsort_bit_ranges(dtype, ranges, descending, rng):
    """begin_bit / end_bit select the same bits of the unsigned order word
    as the JAX package, descending inverts within the field only, and
    rows with equal restricted keys keep their input order."""
    keys = make_keys(rng, dtype, 600)
    for begin, end in ranges:
        check_radixsort(keys, descending, begin, end)


def test_radixsort_bit_range_oracle(rng):
    """The restricted field against numpy: bits [8, 16) of the sign-flipped
    int32 word."""
    keys = rng.integers(0, 1 << 16, 200).astype(np.int32)
    order = check_radixsort(keys, False, 8, 16)
    enc = (keys.view(np.uint32) ^ 0x80000000) >> 8 & 0xFF
    np.testing.assert_array_equal(order, np.argsort(enc, kind="stable"))
    order = check_radixsort(keys, True, 8, 16)
    np.testing.assert_array_equal(order,
                                  np.argsort(255 - enc.astype(np.int64),
                                             kind="stable"))


def test_radixsort_without_values_and_size_mismatch(rng):
    keys = make_keys(rng, np.int32, 50)
    tk, tv = ops.radixsort(Column.from_array(keys, device="cpu"))
    assert tv is None
    np.testing.assert_array_equal(np_of(tk.data), np.sort(keys))
    with pytest.raises(ops.elementwise.GDFError):
        ops.radixsort(Column.from_array(keys, device="cpu"),
                      Column.from_array(keys[:10], device="cpu"))


@pytest.mark.parametrize("dtype", [np.int64, np.float32, np.int8])
@pytest.mark.parametrize("descending,bits", [(False, (0, None)),
                                             (True, (0, None)),
                                             (False, (2, 7)),
                                             (True, (2, 7))])
def test_segmented_radixsort(dtype, descending, bits, rng):
    n = 500
    keys = make_keys(rng, dtype, n)
    vals = np.arange(n, dtype=np.int64)
    offsets = np.asarray([0, 100, 250, 251, 400], np.int32)
    jk, jv = jax.jit(lambda k, v, o: jops.segmented_radixsort(
        k, v, o, descending=descending, begin_bit=bits[0],
        end_bit=bits[1]))(libgdf_tpu.Column.from_array(keys),
                          libgdf_tpu.Column.from_array(vals),
                          jnp.asarray(offsets))
    tk, tv = ops.segmented_radixsort(
        Column.from_array(keys, device="cpu"),
        Column.from_array(vals, device="cpu"), offsets,
        descending=descending, begin_bit=bits[0], end_bit=bits[1])
    np.testing.assert_array_equal(np_of(tv.data), np_of(jv.data))
    np.testing.assert_array_equal(np_of(tk.data), np_of(jk.data))
    got = np_of(tv.data)
    for lo, hi in zip(offsets, list(offsets[1:]) + [n]):
        assert sorted(got[lo:hi].tolist()) == list(range(lo, hi))
    # offsets may come as a tensor as well
    tk2, _ = ops.segmented_radixsort(
        Column.from_array(keys, device="cpu"), None,
        torch.as_tensor(offsets), descending=descending,
        begin_bit=bits[0], end_bit=bits[1])
    np.testing.assert_array_equal(np_of(tk2.data), np_of(tk.data))


def test_segment_ids_from_offsets():
    offsets = np.asarray([0, 3, 3, 7], np.int32)
    want = jsort.segment_ids_from_offsets(jnp.asarray(offsets), 10)
    got = sort.segment_ids_from_offsets(torch.as_tensor(offsets), 10)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ascending,nulls_last", [(True, True),
                                                  ([False, True], False)])
def test_key_operands_hold_the_same_words(ascending, nulls_last, rng):
    """The packed sort words are the JAX package's u64 words with the sign
    bit flipped (signed form)."""
    n = 64
    cols = {"a": rng.integers(-5, 5, n).astype(np.int32),
            "b": rng.standard_normal(n)}
    nulls = {"a": rng.random(n) < 0.3}
    jt, tt = make_tables(cols, nulls, num_rows=50)
    asc = ascending if isinstance(ascending, bool) else tuple(ascending)
    want = jax.jit(lambda t: jsort.key_operands(
        t, ["a", "b"], list(asc) if not isinstance(asc, bool) else asc,
        nulls_last))(jt)
    got = sort.key_operands(tt, ["a", "b"], ascending, nulls_last)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            g.numpy().view(np.uint64) ^ np.uint64(1 << 63), np.asarray(w))


@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("n", [1, 17, 1000])
def test_compaction_indices_order_of_dropped_rows(n, p, rng):
    """A full-length permutation: kept rows first, then the dropped rows,
    both in their original order; and the count."""
    keep = rng.random(n) < p
    jperm, jcount = jax.jit(jcompaction.compaction_indices)(jnp.asarray(keep))
    perm, count = compaction.compaction_indices(torch.as_tensor(keep))
    assert perm.dtype == torch.int32 and count.dtype == torch.int32
    assert int(count) == int(jcount) == int(keep.sum())
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(
        perm.numpy(),
        np.concatenate([np.flatnonzero(keep), np.flatnonzero(~keep)]))


@pytest.mark.parametrize("dropna", [True, False])
def test_count_distinct_and_group_by_wrappers(dropna, rng):
    n = 300
    cols = {"k": rng.integers(0, 20, n).astype(np.int32),
            "j": rng.integers(0, 3, n).astype(np.int64),
            "v": rng.integers(-100, 100, n).astype(np.int64)}
    nulls = {"k": rng.random(n) < 0.1, "v": rng.random(n) < 0.2}
    jt, tt = make_tables(cols, nulls)
    want = jax.jit(lambda t: jops.count_distinct_keys(t, ["k", "j"],
                                                      dropna=dropna))(jt)
    got = ops.count_distinct_keys(tt, ["k", "j"], dropna=dropna)
    assert int(got) == int(want)
    if dropna:
        for name in ("sum", "min", "max", "avg"):
            fn = getattr(jops, f"group_by_{name}")
            assert_tables_match(
                jax.jit(lambda t: fn(t, ["k", "j"], "v"))(jt),
                getattr(ops, f"group_by_{name}")(tt, ["k", "j"], "v"),
                float_tol={"out": (1e-12, 0)})
        assert_tables_match(
            jax.jit(lambda t: jops.group_by_count(t, ["k", "j"]))(jt),
            ops.group_by_count(tt, ["k", "j"]))
