"""Zero-row tables and empty columns, libgdf_tpu_torch against libgdf_tpu.

Where both packages answer, the port's answer equals the JAX package's:
empty outputs of the right names, dtypes and null masks, zero counts and
partition offsets. Where the JAX package fails on a size-0 axis the port
answers or raises its own error, as each test says. A distributed shuffle
with exact split sizes can leave a shard with zero rows, which then runs
the local join and groupby on an empty table.
"""
import jax
import numpy as np
import pytest

import libgdf_tpu
from libgdf_tpu import ops as jops
from libgdf_tpu_torch import GDFError, GDFStatus, Table, ops, table_concat
from torch_parity import assert_tables_match, make_tables, np_of


def _empty(nulls=True):
    cols = {"k": np.zeros(0, np.int64), "v": np.zeros(0, np.float32),
            "w": np.zeros(0, np.int32)}
    return make_tables(cols, {"v": np.zeros(0, bool)} if nulls else None)


def _same(a, b):
    a, b = np_of(a), np_of(b)
    assert a.shape == b.shape == (0,) or np.array_equal(a, b), (a, b)
    assert a.dtype == b.dtype


@pytest.mark.parametrize("num_rows", [None, 0])
def test_filter_table(num_rows):
    jt, tt = _empty()
    if num_rows is not None:
        jt, tt = jt.with_num_rows(0), tt.with_num_rows(0)
    j = jops.filter_table(jt, jops.compare_scalar(jt["v"], 0.0, "lt"))
    t = ops.filter_table(tt, ops.compare_scalar(tt["v"], 0.0, "lt"))
    assert_tables_match(j, t)
    assert int(t.num_rows) == 0


def test_order_by_and_sort_table():
    jt, tt = _empty()
    _same(ops.order_by(tt, ["k", "v"]), jops.order_by(jt, ["k", "v"]))
    assert_tables_match(jops.sort_table(jt, ["k"]), ops.sort_table(tt, ["k"]))


@pytest.mark.parametrize("how", ["inner", "left", "full"])
@pytest.mark.parametrize("side", ["left", "right", "both"])
def test_joins(how, side, rng):
    jl, tl = _empty()
    cols = {"k": rng.integers(0, 5, 40).astype(np.int64),
            "x": rng.standard_normal(40)}
    jr, tr = make_tables(cols)
    if side == "right":
        jl, tl, jr, tr = jr, tr, jl, tl
    if side == "both":
        jr, tr = jl, tl
    *jidx, jcount = jops.join_indices(jl, jr, ["k"], ["k"], how)
    *tidx, tcount = ops.join_indices(tl, tr, ["k"], ["k"], how)
    for a, b in zip(jidx, tidx):
        _same(b, a)
    # the count is int64 in the port; the reference's early return for an
    # empty merge gives an int32 zero
    assert int(tcount) == int(jcount)
    assert_tables_match(jops.join(jl, jr, ["k"], ["k"], how),
                        ops.join(tl, tr, ["k"], ["k"], how))


def test_groupby_and_count_distinct_keys_are_empty():
    """The reference raises here: IndexError from a scatter into a size-0
    axis, or ValueError from a min over it (ROADMAP C "Reference side");
    the port returns no group."""
    jt, tt = _empty()
    aggs = [("v", "sum", "s"), ("v", "count", "c"), ("v", "avg", "a"),
            ("w", "min", "lo"), ("w", "max", "hi")]
    with pytest.raises((IndexError, ValueError)):
        jops.groupby(jt, ["k"], aggs)
    with pytest.raises(IndexError):
        jops.count_distinct_keys(jt, ["k"])
    out = ops.groupby(tt, ["k"], aggs)
    assert out.names == ("k", "s", "c", "a", "lo", "hi")
    assert out.capacity == 0 and int(out.num_rows) == 0
    assert [str(c.data.dtype) for c in out.columns] == [
        "torch.int64", "torch.float32", "torch.int64", "torch.float64",
        "torch.int32", "torch.int32"]
    assert int(ops.count_distinct_keys(tt, ["k"])) == 0


def test_hash_partition_and_hash_columns():
    jt, tt = _empty()
    jp, joff = jops.hash_partition(jt, ["k"], 4)
    tp, toff = ops.hash_partition(tt, ["k"], 4)
    assert_tables_match(jp, tp)
    _same(toff, joff)
    # the port's 32-bit hashes are int64 in [0, 2^32), the reference's
    # uint32
    assert ops.hash_columns([tt["k"], tt["w"]]).shape == (0,)
    assert np_of(jops.hash_columns([jt["k"], jt["w"]])).shape == (0,)


def test_radixsort_cast_add():
    jt, tt = _empty(nulls=False)
    for a, b in zip(jops.radixsort(jt["w"], jt["k"]),
                    ops.radixsort(tt["w"], tt["k"])):
        _same(b.data, a.data)
    _same(ops.cast(tt["w"], ops.elementwise.GDFDtype.FLOAT64).data,
          jops.cast(jt["w"], libgdf_tpu.GDFDtype.FLOAT64).data)
    _same(ops.add(tt["k"], tt["k"]).data, jops.add(jt["k"], jt["k"]).data)


def test_table_concat():
    jt, tt = _empty()
    _, tfull = make_tables({"k": np.arange(3, dtype=np.int64),
                            "v": np.ones(3, np.float32),
                            "w": np.arange(3, dtype=np.int32)},
                           {"v": np.array([False, True, False])})
    jfull = libgdf_tpu.Table.from_dict(
        {"k": np.arange(3, dtype=np.int64), "v": np.ones(3, np.float32),
         "w": np.arange(3, dtype=np.int32)},
        nulls={"v": np.array([False, True, False])})
    assert_tables_match(libgdf_tpu.table_concat([jt, jfull, jt]),
                        table_concat([tt, tfull, tt]))
    assert_tables_match(libgdf_tpu.table_concat([jt]), table_concat([tt]))


def test_sum_of_an_empty_column():
    jt, tt = _empty()
    for col in ("k", "v", "w"):
        for op in ("sum", "product", "sum_squared"):
            _same(ops.reduce(tt[col], op),
                  jax.jit(lambda c: jops.reduce(c, op))(jt[col]))


@pytest.mark.parametrize("fn", ["min", "max", "quantile_exact",
                                "quantile_approx"])
def test_min_max_quantiles_of_an_empty_column_raise(fn):
    """The reference raises ValueError (min / max) or IndexError
    (quantiles); the port raises GDFError(GDF_DATASET_EMPTY)."""
    jt, tt = _empty()
    args = {"min": (), "max": (), "quantile_exact": (0.5,),
            "quantile_approx": (0.5,)}[fn]
    with pytest.raises((ValueError, IndexError)):
        getattr(jops, fn)(jt["v"], *args)
    with pytest.raises(GDFError) as err:
        getattr(ops, fn)(tt["v"], *args)
    assert err.value.status == GDFStatus.GDF_DATASET_EMPTY


def test_zero_row_table_from_dict_keeps_its_schema():
    t = Table.from_dict({"k": np.zeros(0, np.int64)}, device="cpu")
    assert t.capacity == 0 and t.names == ("k",)
