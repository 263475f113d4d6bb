"""libgdf_tpu_torch operators against libgdf_tpu's, on the CPU.

The same numpy inputs go through both packages (the JAX package runs its
XLA paths on the CPU). Tolerances: integers, counts, validity, join
indices and row order exact; float32 sums rtol=1e-4, atol=1e-4 (the
groupby sort and the scans add in another order, as in
tests/test_pipeline_fuzz.py); float64 sums and averages rtol=1e-12,
atol=1e-12 (float64 scans in another association order).
"""
import numpy as np
import pytest

import libgdf_tpu.ops as jops
import libgdf_tpu_torch.ops as tops
from torch_parity import assert_tables_match, jax_op, make_tables, np_of

F32_SUM = (1e-4, 1e-4)
F64_SUM = (1e-12, 1e-12)
N = 500  # one row count for most tests: the JAX side compiles per shape


def _data(rng, n, kdt=np.int32, nkeys=20, null_p=0.1):
    keys = rng.integers(0, nkeys, n).astype(kdt)
    cols = {"k": keys,
            "i32": rng.integers(-1000, 1000, n).astype(np.int32),
            "i64": rng.integers(-2**40, 2**40, n).astype(np.int64),
            "f32": rng.standard_normal(n).astype(np.float32),
            "f64": rng.standard_normal(n)}
    nulls = {name: rng.random(n) < null_p for name in cols}
    return cols, nulls


@pytest.mark.parametrize("op", ["lt", "le", "gt", "ge", "eq", "ne", 2])
@pytest.mark.parametrize("col,value", [("i32", 10), ("i32", 10.5),
                                       ("i64", -7), ("f32", 0.25),
                                       ("f64", -0.5)])
def test_compare_scalar(rng, op, col, value):
    cols, nulls = _data(rng, N)
    cols["i32"][:5] = 10
    jt, tt = make_tables(cols, nulls)
    j = jops.compare_scalar(jt[col], value, op)
    t = tops.compare_scalar(tt[col], value, op)
    np.testing.assert_array_equal(np_of(t.data), np_of(j.data))
    np.testing.assert_array_equal(np_of(t.valid), np_of(j.valid))
    assert t.info.gdf_dtype.value == j.info.gdf_dtype.value


@pytest.mark.parametrize("op", ["lt", "ge", "eq", 1])
def test_compare_columns(rng, op):
    cols, nulls = _data(rng, N)
    cols["i64"][:50] = cols["i32"][:50]
    jt, tt = make_tables(cols, nulls)
    for a, b in (("i32", "k"), ("f32", "f64"), ("i64", "i32")):
        j = jops.compare(jt[a], jt[b], op)
        t = tops.compare(tt[a], tt[b], op)
        np.testing.assert_array_equal(np_of(t.data), np_of(j.data))
        np.testing.assert_array_equal(np_of(t.valid), np_of(j.valid))


@pytest.mark.parametrize("num_rows", [None, 450])
def test_filter_table(rng, num_rows):
    cols, nulls = _data(rng, N)
    jt, tt = make_tables(cols, nulls, num_rows=num_rows)
    jf = jax_op("filter_table", jt,
                jops.compare_scalar(jt["f32"], 0.1, "lt"))
    tf = tops.filter_table(tt, tops.compare_scalar(tt["f32"], 0.1, "lt"))
    assert int(tf.num_rows) == int(jf.num_rows)
    assert_tables_match(jf, tf)


@pytest.mark.parametrize("keys,ascending,num_rows", [
    (["i64", "f32"], [False, True], None),
    (["k", "f64", "i32"], [True, False, True], 450),
    (["f32"], False, 450),
])
@pytest.mark.parametrize("nulls_last", [True, False])
def test_order_by(rng, keys, ascending, nulls_last, num_rows):
    cols, nulls = _data(rng, N, nkeys=5)
    cols["f32"][:8] = [0.0, -0.0, np.nan, np.inf, -np.inf, 1.0, 1.0, -0.0]
    cols["f64"][:4] = [0.0, -0.0, np.nan, 1e-310]
    jt, tt = make_tables(cols, nulls, num_rows=num_rows)
    asc = ascending if isinstance(ascending, bool) else tuple(ascending)
    jp = jax_op("order_by", jt, key_names=tuple(keys), ascending=asc,
                nulls_last=nulls_last)
    tp = tops.order_by(tt, keys, ascending=ascending, nulls_last=nulls_last)
    np.testing.assert_array_equal(np_of(tp), np_of(jp))


def test_sort_table(rng):
    cols, nulls = _data(rng, N, nkeys=7)
    jt, tt = make_tables(cols, nulls, num_rows=450)
    assert_tables_match(jax_op("sort_table", jt, key_names=("k", "f32"),
                               ascending=(True, False)),
                        tops.sort_table(tt, ["k", "f32"], [True, False]))


def _join_inputs(rng, kdt, dup, stretch, n=400, m=120, nkeys=60):
    lk = rng.integers(0, nkeys, n).astype(kdt)
    rk = (np.repeat(rng.permutation(nkeys)[:m // 3], 3) if dup
          else rng.permutation(nkeys * 2)[:m]).astype(kdt)
    if stretch:
        lk = lk + (lk % 3).astype(kdt) * kdt(1 << 40)
        rk = rk + (rk % 3).astype(kdt) * kdt(1 << 40)
    left = ({"k": lk, "a": np.arange(n, dtype=np.int32)},
            {"k": rng.random(n) < 0.1})
    right = ({"k": rk, "b": rng.standard_normal(len(rk)).astype(np.float32)},
             {"k": rng.random(len(rk)) < 0.1})
    return left, right


@pytest.mark.parametrize("how", ["inner", "left", "full"])
@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("kdt,stretch", [(np.int32, False),
                                         (np.int64, True)])
def test_join_indices(rng, how, dup, kdt, stretch):
    (lc, ln), (rc, rn) = _join_inputs(rng, kdt, dup, stretch)
    jl, tl = make_tables(lc, ln, num_rows=380)
    jr, tr = make_tables(rc, rn)
    ji, jj, jc = jops.join_indices(jl, jr, ["k"], ["k"], how=how)
    ti, tj, tc = tops.join_indices(tl, tr, ["k"], ["k"], how=how)
    assert int(tc) == int(jc)
    np.testing.assert_array_equal(np_of(ti), np_of(ji))
    np.testing.assert_array_equal(np_of(tj), np_of(jj))


@pytest.mark.parametrize("how", ["inner", "full"])
def test_join_multi_key_and_float_keys(rng, how):
    n, m = 400, 120
    lc = {"a": rng.integers(0, 6, n).astype(np.int32),
          "b": rng.choice([0.0, -0.0, 1.5, np.nan, 2.5], n)}
    rc = {"a": rng.integers(0, 6, m).astype(np.int32),
          "b": rng.choice([0.0, 1.5, np.nan, 2.5], m)}
    jl, tl = make_tables(lc, {"a": rng.random(n) < 0.1})
    jr, tr = make_tables(rc)
    for keys in (["a", "b"], ["b"]):
        ji, jj, jc = jops.join_indices(jl, jr, keys, keys, how=how,
                                       out_capacity=20_000)
        ti, tj, tc = tops.join_indices(tl, tr, keys, keys, how=how,
                                       out_capacity=20_000)
        assert int(tc) == int(jc)
        np.testing.assert_array_equal(np_of(ti), np_of(ji))
        np.testing.assert_array_equal(np_of(tj), np_of(jj))


def test_join_assume_unique_build_poisons_count(rng):
    (lc, ln), (rc, rn) = _join_inputs(rng, np.int32, True, False)
    jl, tl = make_tables(lc, ln)
    jr, tr = make_tables(rc, rn)
    _, _, jc = jax_op("inner_join", jl, jr, left_on=("k",), right_on=("k",),
                      out_capacity=2000, assume_unique_build=True)
    _, _, tc = tops.inner_join(tl, tr, ["k"], ["k"], out_capacity=2000,
                               assume_unique_build=True)
    assert int(tc) == int(jc) == -1


I32 = np.iinfo(np.int32)
I64 = np.iinfo(np.int64)
F32_TINY = np.finfo(np.float32).tiny
F64_TINY = np.finfo(np.float64).tiny


def _unique(rng, values, m):
    return rng.permutation(np.asarray(values))[:m]


def _hash_case(rng, case):
    """((left columns, nulls, num_rows), (right ...)) of a case of the hash
    path: an inner join on one key, the right side the build side."""
    n, m = 400, 120
    lnull = rnull = None
    lrows = rrows = None
    if case == "duplicate_build":
        rk = _unique(rng, np.arange(300), m).astype(np.int32)
        rk[7] = rk[60]
        lk = rng.integers(0, 300, n).astype(np.int32)
    elif case == "nulls_nan_dead":
        rk = _unique(rng, np.arange(240) / 4, m)
        rk[::9] = np.nan                   # NaN repeats: never inserted
        rrows = 100
        rk[rrows:] = rk[1:m - rrows + 1]   # dead rows repeat live keys
        rnull = rng.random(m) < 0.1
        rk[rnull] = rk[1]                  # and so do nulls
        lk = rng.integers(0, 240, n) / 4
        lk[::13] = np.nan
        lnull = rng.random(n) < 0.1
        lrows = 380
    elif case in ("signed_zero_denormal_f32", "signed_zero_denormal_f64"):
        dt = np.float32 if case.endswith("f32") else np.float64
        tiny = F32_TINY if dt == np.float32 else F64_TINY
        rk = np.concatenate([[-0.0, 1.5, 2.5, -tiny], np.arange(4, m)])
        rk = rng.permutation(rk).astype(dt)
        lk = rng.choice([0.0, -0.0, tiny / 2, -tiny / 4, tiny, -tiny, 1.5,
                         2.5, np.nan, 9.0], n).astype(dt)
    elif case == "int64_wide":
        wide = np.array([I64.min, I64.max, -1, 0, 1 << 32, (1 << 32) + 1,
                         -(1 << 32), (1 << 40) + 7], np.int64)
        rk = np.concatenate([wide, (np.arange(m - len(wide)) << 33) + 5])
        rk = rng.permutation(rk)
        lk = rng.choice(np.concatenate([rk, rk + 1]), n)
    elif case == "int32_extremes":
        rk = np.concatenate([[I32.min, I32.max, -1, 0],
                             np.arange(10, 10 + m - 4)]).astype(np.int32)
        rk = rng.permutation(rk)
        lk = rng.choice(np.concatenate([rk, [I32.min + 1, I32.max - 1]]),
                        n).astype(np.int32)
    elif case == "int16":
        rk = _unique(rng, np.arange(-200, 200), m).astype(np.int16)
        lk = rng.integers(-300, 300, n).astype(np.int16)
    elif case == "empty_build":
        rk = np.zeros(0, np.int32)
        lk = rng.integers(0, 50, n).astype(np.int32)
    elif case == "empty_probe":
        rk = _unique(rng, np.arange(300), m).astype(np.int32)
        lk = np.zeros(0, np.int32)
    elif case == "no_match":
        rk = _unique(rng, np.arange(300), m).astype(np.int32)
        lk = rng.integers(1000, 2000, n).astype(np.int32)
    elif case == "every_row_matches":
        rk = _unique(rng, np.arange(300), m).astype(np.int32)
        lk = rng.choice(rk, n).astype(np.int32)
    else:
        raise ValueError(case)
    left = ({"k": lk, "a": np.arange(len(lk), dtype=np.int32)},
            None if lnull is None else {"k": lnull}, lrows)
    right = ({"k": rk, "b": np.arange(len(rk), dtype=np.float32)},
             None if rnull is None else {"k": rnull}, rrows)
    return left, right


HASH_CASES = ["duplicate_build", "nulls_nan_dead", "signed_zero_denormal_f32",
              "signed_zero_denormal_f64", "int64_wide", "int32_extremes",
              "int16", "empty_build", "empty_probe", "no_match",
              "every_row_matches"]


@pytest.mark.parametrize("case", HASH_CASES)
def test_join_hash_path_cases(rng, case):
    """The inner join on one key through the hash path (the sort path where
    the build side repeats a live key) gives the JAX package's indices, in
    its order, and count."""
    from libgdf_tpu_torch.utils import tracing
    (lc, ln, lrows), (rc, rn, rrows) = _hash_case(rng, case)
    jl, tl = make_tables(lc, ln, num_rows=lrows)
    jr, tr = make_tables(rc, rn, num_rows=rrows)
    ji, jj, jc = jops.join_indices(jl, jr, ["k"], ["k"], how="inner")
    tracing.reset_counters()
    ti, tj, tc = tops.join_indices(tl, tr, ["k"], ["k"], how="inner")
    got = tracing.counters()
    want = ({"join.hash_fallback": 1, "join.sort": 1}
            if case == "duplicate_build" else {"join.hash": 1})
    assert {k: v for k, v in got.items() if k.startswith("join.")} == want
    assert int(tc) == int(jc)
    np.testing.assert_array_equal(np_of(ti), np_of(ji))
    np.testing.assert_array_equal(np_of(tj), np_of(jj))


@pytest.mark.parametrize("case", ["every_row_matches", "int64_wide"])
def test_join_hash_path_out_capacity(rng, case):
    """An out_capacity at the count pads with nothing, one above it with
    -1; one below it raises, as on the sort path."""
    from libgdf_tpu_torch import GDFError
    (lc, ln, _), (rc, rn, _) = _hash_case(rng, case)
    jl, tl = make_tables(lc, ln)
    jr, tr = make_tables(rc, rn)
    ti, tj, tc = tops.join_indices(tl, tr, ["k"], ["k"])
    count = int(tc)
    assert count > 0
    for cap in (count, count + 3):
        ji, jj, jc = jax_op("join_indices", jl, jr, left_on=("k",),
                            right_on=("k",), how="inner", out_capacity=cap)
        ci, cj, cc = tops.join_indices(tl, tr, ["k"], ["k"],
                                       out_capacity=cap)
        assert int(cc) == int(jc) == count
        np.testing.assert_array_equal(np_of(ci), np_of(ji))
        np.testing.assert_array_equal(np_of(cj), np_of(jj))
    with pytest.raises(GDFError):
        tops.join_indices(tl, tr, ["k"], ["k"], out_capacity=count - 1)


@pytest.mark.parametrize("how,keys,dup,want", [
    ("inner", ["k"], False, {"join.hash": 1}),
    ("inner", ["k"], True, {"join.hash_fallback": 1, "join.sort": 1}),
    ("left", ["k"], False, {"join.sort": 1}),
    ("full", ["k"], False, {"join.sort": 1}),
    ("inner", ["k", "a"], False, {"join.sort": 1}),
], ids=["inner_unique", "inner_duplicate", "left", "full", "multi_key"])
def test_join_path_follows_the_input(rng, how, keys, dup, want):
    """Which path a join takes, by the counters: the hash path for an inner
    join on one key of a unique build side (one host read), the sort path
    (three) after a duplicate and for every other join."""
    from libgdf_tpu_torch.utils import tracing
    (lc, ln), (rc, rn) = _join_inputs(rng, np.int32, dup, False)
    lc, rc = dict(lc), dict(rc)
    rc["a"] = rng.integers(0, 3, len(rc["k"])).astype(np.int32)
    lc["a"] = rng.integers(0, 3, len(lc["k"])).astype(np.int32)
    _, tl = make_tables(lc, ln)
    _, tr = make_tables(rc, rn)
    tracing.reset_counters()
    tops.join_indices(tl, tr, keys, keys, how=how)
    got = tracing.counters()
    assert {k: v for k, v in got.items() if k.startswith("join.")} == want
    sort_reads = {"host_sync.join.key_change", "host_sync.join.total",
                  "host_sync.join.unique_build"}
    reads = {k for k in got if k.startswith("host_sync.")}
    hash_read = {"host_sync.join.hash.count"}
    assert reads == (hash_read if "join.hash" in want else
                     sort_reads | (hash_read if dup and how == "inner"
                                   else set()))


@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_join_materialized(rng, how):
    (lc, ln), (rc, rn) = _join_inputs(rng, np.int64, True, False)
    jl, tl = make_tables(lc, ln)
    jr, tr = make_tables(rc, rn)
    assert_tables_match(jops.join(jl, jr, ["k"], ["k"], how=how),
                        tops.join(tl, tr, ["k"], ["k"], how=how))


AGGS = (("i32", "sum", "s32"), ("i64", "sum", "s64"), ("f32", "sum", "sf"),
        ("f64", "sum", "sd"), ("i32", "min", "mn32"), ("i64", "max", "mx64"),
        ("f32", "max", "mxf"), ("f64", "min", "mnd"), ("f32", "count", "c"),
        ("f64", "avg", "ad"), ("i32", "avg", "a32"),
        ("f32", "count_distinct", "cd"))
AGG_TOL = {"sf": F32_SUM, "sd": F64_SUM, "ad": F64_SUM, "a32": F64_SUM}


@pytest.mark.parametrize("kdt,dropna,num_rows", [
    (np.int32, True, None), (np.int32, False, 450), (np.int64, True, 450),
    (np.int64, False, None)])
def test_groupby(rng, kdt, dropna, num_rows):
    cols, nulls = _data(rng, N, kdt=kdt, nkeys=30)
    cols["f32"][:3] = np.nan  # NaN in a 4-byte max: propagates in both
    jt, tt = make_tables(cols, nulls, num_rows=num_rows)
    jg = jax_op("groupby", jt, key_names=("k",), aggs=AGGS, dropna=dropna)
    tg = tops.groupby(tt, ["k"], AGGS, dropna=dropna)
    assert int(tg.num_rows) == int(jg.num_rows)
    assert_tables_match(jg, tg, AGG_TOL, tie_keys=["k"],
                        tie_break=["s32", "s64", "mn32", "mx64", "c"])


def test_groupby_two_keys_and_avg_from_siblings(rng):
    cols, nulls = _data(rng, N, nkeys=8)
    cols["k2"] = rng.integers(-3, 3, N).astype(np.int64)
    nulls["k2"] = rng.random(N) < 0.05
    aggs = (("f32", "sum", "s"), ("f32", "count", "c"), ("f32", "avg", "a"),
            ("f64", "max", "hi"))
    jt, tt = make_tables(cols, nulls)
    for dropna in (True, False):
        jg = jax_op("groupby", jt, key_names=("k2", "k"), aggs=aggs,
                    dropna=dropna)
        tg = tops.groupby(tt, ["k2", "k"], aggs, dropna=dropna)
        assert_tables_match(jg, tg, {"s": F32_SUM, "a": F32_SUM},
                            tie_keys=["k2", "k"], tie_break=["c", "hi"])


def test_groupby_float_keys(rng):
    n = N
    cols = {"k": rng.choice([0.0, -0.0, 1.5, -2.25, np.inf], n)
            .astype(np.float32),
            "v": rng.integers(0, 100, n).astype(np.int64)}
    jt, tt = make_tables(cols, {"k": rng.random(n) < 0.1})
    aggs = (("v", "sum", "s"), ("v", "min", "m"))
    for dropna in (True, False):
        assert_tables_match(
            jax_op("groupby", jt, key_names=("k",), aggs=aggs, dropna=dropna),
            tops.groupby(tt, ["k"], aggs, dropna=dropna),
            tie_keys=["k"], tie_break=["s", "m"])


@pytest.mark.parametrize("nkeys", [1, 2])
def test_argsort_keys(rng, nkeys):
    """engine.argsort_keys: the sorted keys, the permutation and the
    payloads, ties in input order (stable). `stable` is accepted and the
    sort stays stable."""
    import jax
    import libgdf_tpu.ops.engine as jeng
    import libgdf_tpu_torch.ops.engine as teng
    import torch

    keys = [rng.integers(0, 7, N).astype(np.int32),
            rng.integers(-3, 3, N).astype(np.int64)][:nkeys]
    pay = [rng.standard_normal(N), rng.integers(0, 99, N).astype(np.int32)]
    jk, jp, jpay = jax.jit(lambda k, p: jeng.argsort_keys(k, p))(keys, pay)
    tk, tp, tpay = teng.argsort_keys([torch.as_tensor(k) for k in keys],
                                     [torch.as_tensor(p) for p in pay])
    for a, b in zip(list(jk) + [jp] + list(jpay), list(tk) + [tp] + tpay):
        np.testing.assert_array_equal(np_of(b), np_of(a))
    (s,) = teng.multi_sort([torch.as_tensor(keys[0])], 1, stable=False)
    np.testing.assert_array_equal(s.numpy(), np.sort(keys[0], kind="stable"))


def _dense_case(rng, case):
    """(columns, nulls, keys, aggs, dropna, num_rows, path) of one dense
    group-by case; dead rows past num_rows hold keys outside the domain."""
    n = N
    kdt = {"int16": np.int16, "int32": np.int32, "int64": np.int64,
           "date32": np.int32}.get(case, np.int8)
    span = {"one_slot": 1, "at_the_cap": 8, "over_the_cap": 9}.get(case, 3)
    cols = {"k": (rng.integers(0, span, n) - 2).astype(kdt),
            "k2": rng.integers(7, 9 if span <= 4 else 8, n).astype(kdt),
            "f32": rng.standard_normal(n).astype(np.float32),
            "f64": rng.standard_normal(n),
            "i8": rng.integers(-128, 128, n).astype(np.int8),
            "i32": rng.integers(-1000, 1000, n).astype(np.int32)}
    if case == "denormals":
        cols["f32"][::3] = np.float32(1e-40)
        cols["f64"][1::3] = -1e-310
    if case == "int8_wraps":
        cols["i8"][:] = 100
    nulls = {}
    if case == "nullable_values":
        nulls = {c: rng.random(n) < 0.2 for c in ("f32", "f64", "i8")}
    if case == "nullable_keys":
        nulls = {"k": rng.random(n) < 0.1, "k2": rng.random(n) < 0.1}
    num_rows = {"no_live_row": 0}.get(case, 450)
    for name in ("k", "k2"):
        cols[name][num_rows:] = 100     # stale keys in the dead rows
    keys = ("k",) if case in ("one_key", "at_the_cap", "over_the_cap",
                              "one_slot") else ("k", "k2")
    aggs = (("f64", "sum", "sd"), ("f32", "sum", "sf"), ("i8", "sum", "s8"),
            ("f64", "avg", "ad"), ("f32", "count", "cf"),
            ("f32", "avg", "af"), ("i32", "avg", "ai"), ("k", "count", "n"))
    if case == "avg_from_siblings":
        aggs = (("f64", "sum", "sd"), ("f64", "count", "cd"),
                ("f64", "avg", "ad"), ("i8", "sum", "s8"),
                ("i8", "count", "c8"), ("i8", "avg", "a8"))
    if case == "nullable_values":
        aggs = (("f64", "sum", "sd"), ("f64", "avg", "ad"),
                ("f32", "count", "cf"), ("i8", "sum", "s8"),
                ("i8", "avg", "a8"))
    dense = case not in ("over_the_cap", "no_live_row")
    return cols, nulls, keys, aggs, num_rows, dense


DENSE_CASES = ["int8", "int16", "int32", "int64", "date32", "one_key",
               "one_slot", "at_the_cap", "over_the_cap", "nullable_keys",
               "nullable_values", "denormals", "int8_wraps",
               "avg_from_siblings", "no_live_row"]


@pytest.mark.parametrize("case", DENSE_CASES)
def test_groupby_dense_domain(rng, case):
    """The dense path (H5's plain version) against libgdf_tpu's sort: small
    integer key domains, dead rows with stale keys, nulls, denormals, a
    wrapping int8 sum, averages alone and from siblings; over the cap and
    with no live row, the sort path."""
    from dataclasses import replace

    import libgdf_tpu.core.dtypes as jdt
    import libgdf_tpu_torch.core.dtypes as tdt
    from libgdf_tpu_torch.utils import tracing
    cols, nulls, keys, aggs, num_rows, dense = _dense_case(rng, case)
    jt, tt = make_tables(cols, nulls, num_rows=num_rows)
    if case == "date32":
        jt = jt.replace_column("k", replace(
            jt["k"], info=jdt.DtypeInfo(jdt.GDFDtype.DATE32)))
        tt = tt.replace_column("k", replace(
            tt["k"], info=tdt.DtypeInfo(tdt.GDFDtype.DATE32)))
    jg = jax_op("groupby", jt, key_names=keys, aggs=aggs, dropna=True)
    tracing.reset_counters()
    tg = tops.groupby(tt, list(keys), aggs)
    got = tracing.counters()
    assert got.get("groupby.dense", 0) == int(dense)
    assert got.get("groupby.sort", 0) == int(not dense)
    assert int(tg.num_rows) == int(jg.num_rows)
    tol = {"sd": F64_SUM, "ad": F64_SUM, "sf": F32_SUM, "af": F32_SUM,
           "ai": F64_SUM, "a8": F64_SUM}
    assert_tables_match(jg, tg, tol)
