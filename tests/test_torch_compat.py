"""libgdf_tpu_torch.compat.gdf against libgdf_tpu.compat.gdf, on the CPU.

The two flat surfaces hold the same 300 names. Each entry family is called
through both packages on the same numpy data, and one pipeline (view ->
compare -> stencil -> join -> group_by -> order_by -> radixsort ->
prefixsum -> csr) runs through both at a few thousand rows. Integers,
masks, row order and output dtypes are exact; unary math rtol 1e-6 at
float32; float64 group sums rtol 1e-12.
"""
import numpy as np
import pytest
import torch

import libgdf_tpu
from libgdf_tpu.compat import gdf as jgdf
from libgdf_tpu_torch import Column, GDFDtype, GDFError, GDFStatus, TimeUnit
from libgdf_tpu_torch.compat import gdf
from libgdf_tpu_torch.core.dtypes import (WindowFunctionType,
                                          WindowReductionType)
from torch_parity import np_of


def view(data, null=None, dtype=None, unit=None):
    """gdf_column_view of the same data in both packages."""
    valid = None if null is None else ~null
    jd = None if dtype is None else getattr(libgdf_tpu.GDFDtype, dtype.name)
    jc = jgdf.gdf_column_view(data, valid, len(data), jd)
    tc = gdf.gdf_column_view(data, valid, len(data), dtype, device="cpu")
    if unit is not None:
        ju = getattr(libgdf_tpu.TimeUnit, unit.name)
        jc = libgdf_tpu.Column.from_array(data, valid, jd, ju)
        tc = Column.from_array(data, valid, dtype, unit, device="cpu")
    return jc, tc


def same(jc, tc, rtol=None):
    """One column from each package: dtype, validity, valid values."""
    assert tc.info.gdf_dtype.value == jc.info.gdf_dtype.value
    jv, tv = np_of(jc.data), np_of(tc.data)
    assert tv.dtype == jv.dtype and tv.shape == jv.shape
    assert (tc.valid is None) == (jc.valid is None)
    ok = np.ones(jv.shape, bool)
    if jc.valid is not None:
        np.testing.assert_array_equal(np_of(tc.valid), np_of(jc.valid))
        ok = np_of(jc.valid)
    if rtol is None:
        np.testing.assert_array_equal(tv[ok], jv[ok])
    else:
        np.testing.assert_allclose(tv[ok], jv[ok], rtol=rtol)


def same_columns(jcols, tcols, rtol=None):
    assert len(jcols) == len(tcols)
    for jc, tc in zip(jcols, tcols):
        same(jc, tc, rtol)


def test_surface_has_the_same_300_names():
    assert set(gdf.__all__) == set(jgdf.__all__)
    assert len(gdf.__all__) == len(set(gdf.__all__)) == 300
    for name in gdf.__all__:
        assert callable(getattr(gdf, name)), name
    assert callable(gdf.gdf_window_function)
    assert gdf.gdf_column_sizeof() == jgdf.gdf_column_sizeof()


def test_column_view_device_rule(monkeypatch):
    """numpy goes to the card and raises without CUDA unless device="cpu"
    is passed; a tensor stays where it is."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(GDFError, match="device='cpu'"):
        gdf.gdf_column_view(np.arange(4))
    with pytest.raises(GDFError, match="device='cpu'"):
        gdf.gdf_count_nonzero_mask(np.ones(4, bool))
    with pytest.raises(GDFError, match="device='cpu'"):
        gdf.all_bitmask_on(4)
    c = gdf.gdf_column_view(torch.arange(4), torch.tensor([1, 0, 1, 1],
                                                          dtype=torch.bool))
    assert c.device.type == "cpu" and int(c.null_count()) == 1
    with pytest.raises(GDFError):
        gdf.gdf_column_view(np.arange(4), size=5, device="cpu")


def test_column_view_takes_a_packed_bitmask(rng):
    x = rng.integers(0, 9, 21).astype(np.int32)
    packed = np.packbits(rng.random(21) < 0.5, bitorder="little")
    jc = jgdf.gdf_column_view_augmented(x, packed, 21, null_count=3)
    tc = gdf.gdf_column_view_augmented(x, packed, 21, null_count=3,
                                       device="cpu")
    same(jc, tc)
    assert int(gdf.gdf_count_nonzero_mask(tc)) == \
        int(jgdf.gdf_count_nonzero_mask(jc))
    assert int(gdf.gdf_count_nonzero_mask(packed, 21, device="cpu")) == \
        int(jgdf.gdf_count_nonzero_mask(packed, 21))
    assert gdf.get_column_byte_width(tc) == jgdf.get_column_byte_width(jc)
    assert gdf.gdf_column_free(tc) is None


def test_unary_typed_and_generic(rng):
    x = rng.random(100).astype(np.float32) + 0.1
    jc, tc = view(x, rng.random(100) < 0.1)
    same(jgdf.gdf_sin_f32(jc), gdf.gdf_sin_f32(tc), rtol=1e-6)
    same(jgdf.gdf_log_generic(jc), gdf.gdf_log_generic(tc), rtol=1e-6)
    with pytest.raises(GDFError) as e:
        gdf.gdf_sin_f64(tc)  # wrong dtype guard
    assert e.value.status == GDFStatus.GDF_UNSUPPORTED_DTYPE


def test_binary_typed(rng):
    a = rng.integers(0, 100, 50).astype(np.int32)
    b = rng.integers(0, 100, 50).astype(np.int32)   # zeros in the divisor
    (ja, ta), (jb, tb) = view(a, rng.random(50) < 0.2), view(b)
    for name in ("gdf_add_i32", "gdf_mul_generic", "gdf_floordiv_i32",
                 "gdf_floordiv_generic", "gdf_bitwise_xor_i32", "gdf_ne_i32"):
        same(getattr(jgdf, name)(ja, jb), getattr(gdf, name)(ta, tb))
    out = gdf.gdf_lt_i32(ta, tb)
    assert out.data.dtype == torch.int8  # comparison output is i8
    same(jgdf.gdf_lt_i32(ja, jb), out)
    with pytest.raises(GDFError):
        gdf.gdf_add_i64(ta, tb)
    same(jgdf.gdf_validity_and(ja, jb), gdf.gdf_validity_and(ta, tb))


def test_cast_matrix(rng):
    x = rng.integers(-100, 100, 32).astype(np.int32)
    jc, tc = view(x)
    jf, tf = jgdf.gdf_cast_i32_to_f64(jc), gdf.gdf_cast_i32_to_f64(tc)
    same(jf, tf)
    same(jgdf.gdf_cast_f64_to_i32(jf), gdf.gdf_cast_f64_to_i32(tf))
    np.testing.assert_array_equal(np_of(gdf.gdf_cast_f64_to_i32(tf).data), x)
    same(jgdf.gdf_cast_generic_to_i8(jc), gdf.gdf_cast_generic_to_i8(tc))
    y = np.array([np.nan, np.inf, -np.inf, 3e10, 300.7], np.float32)
    jy, ty = view(y)
    same(jgdf.gdf_cast_f32_to_i32(jy), gdf.gdf_cast_f32_to_i32(ty))
    same(jgdf.gdf_cast_f32_to_i8(jy), gdf.gdf_cast_f32_to_i8(ty))
    same(jgdf.gdf_cast_f32_to_timestamp(jy, libgdf_tpu.TimeUnit.us),
         gdf.gdf_cast_f32_to_timestamp(ty, TimeUnit.us))


def test_cast_date32_to_date64():
    days = np.array([0, 1, -1, 18000], dtype=np.int32)
    jc, tc = view(days, dtype=GDFDtype.DATE32)
    ms = gdf.gdf_cast_date32_to_date64(tc)
    same(jgdf.gdf_cast_date32_to_date64(jc), ms)
    np.testing.assert_array_equal(np_of(ms.data),
                                  days.astype(np.int64) * 86400000)


def test_datetime_extract_entries(rng):
    ms = rng.integers(-2 * 10**12, 4 * 10**12, 100)
    jc, tc = view(ms, rng.random(100) < 0.2, GDFDtype.TIMESTAMP,
                  TimeUnit.ms)
    for part in ("year", "month", "day", "hour", "minute", "second"):
        name = f"gdf_extract_datetime_{part}"
        same(getattr(jgdf, name)(jc), getattr(gdf, name)(tc))


def test_reductions_and_prefixsum(rng):
    x = rng.integers(1, 10, 64).astype(np.int32)
    jc, tc = view(x)
    assert int(gdf.gdf_sum_i32(tc)) == int(jgdf.gdf_sum_i32(jc)) == x.sum()
    assert int(gdf.gdf_max_generic(tc)) == x.max()
    assert int(gdf.gdf_product_i32(tc)) == int(jgdf.gdf_product_i32(jc))
    assert gdf.gdf_reduce_optimal_output_size() == 128
    for inclusive in (True, False):
        same(jgdf.gdf_prefixsum_i32(jc, inclusive),
             gdf.gdf_prefixsum_i32(tc, inclusive))
    same(jgdf.gdf_prefixsum_generic(jc), gdf.gdf_prefixsum_generic(tc))
    with pytest.raises(GDFError):
        gdf.gdf_prefixsum_i64(tc)
    f = rng.standard_normal(64).astype(np.float32)
    jf, tf = view(f, rng.random(64) < 0.3)
    np.testing.assert_allclose(float(gdf.gdf_sum_squared_f32(tf)),
                               float(jgdf.gdf_sum_squared_f32(jf)),
                               rtol=1e-5)
    assert float(gdf.gdf_min_f32(tf)) == float(jgdf.gdf_min_f32(jf))


def test_comparison_static_and_stencil(rng):
    x = rng.standard_normal(200).astype(np.float32)
    jc, tc = view(x, rng.random(200) < 0.2)
    jst = jgdf.gpu_comparison_static_f32(jc, 0.0, "gt")
    tst = gdf.gpu_comparison_static_f32(tc, 0.0, "gt")
    same(jst, tst)
    out = gdf.gpu_apply_stencil(tc, tst)
    same(jgdf.gpu_apply_stencil(jc, jst), out)
    assert out.size < 200
    same(jgdf.gpu_comparison(jc, jc, 3), gdf.gpu_comparison(tc, tc, 3))
    with pytest.raises(GDFError):
        gdf.gpu_comparison_static_i16(tc, 0, "gt")


def test_concat_and_masks(rng):
    null = np.array([True, False, False, True, False])
    ja, ta = view(np.arange(5, dtype=np.int32), null)
    jb, tb = view(np.arange(3, dtype=np.int32))
    out = gdf.gpu_concat(ta, tb)
    same(jgdf.gpu_concat(ja, jb), out)
    assert out.size == 8
    assert int(gdf.gdf_count_nonzero_mask(out)) == 6
    same(jgdf.gdf_column_concat([jb, ja, jb]),
         gdf.gdf_column_concat([tb, ta, tb]))
    assert gdf.gdf_get_num_chars_bitmask(17) == 3
    np.testing.assert_array_equal(
        np_of(gdf.gdf_mask_concat([ta.valid, None], [5, 3])),
        np_of(jgdf.gdf_mask_concat([ja.valid, None], [5, 3])))
    np.testing.assert_array_equal(
        np_of(gdf.all_bitmask_on(7, device="cpu")),
        np_of(jgdf.all_bitmask_on(7)))
    np.testing.assert_array_equal(
        np_of(gdf.apply_bitmask_to_bitmask(ta.valid, ta.valid)),
        np_of(ta.valid))
    with pytest.raises(GDFError):
        gdf.gpu_concat(ta, gdf.gdf_cast_i32_to_i64(tb))


def _named(jc, tc, name):
    return jc.with_name(name), tc.with_name(name)


@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_join_entry_points(how, rng):
    n, m = 300, 120
    jlk, tlk = _named(*view(rng.integers(0, 60, n).astype(np.int32),
                            rng.random(n) < 0.1), "k")
    jlv, tlv = _named(*view(rng.standard_normal(n).astype(np.float32)), "v")
    jrk, trk = _named(*view(rng.permutation(m).astype(np.int32)), "k")
    jrw, trw = _named(*view(rng.integers(0, 9, m), rng.random(m) < 0.3), "w")
    name = f"gdf_{how}_join"
    jout = getattr(jgdf, name)([jlk, jlv], 2, [0], [jrk, jrw], 2, [0], 1)
    tout = getattr(gdf, name)([tlk, tlv], 2, [0], [trk, trw], 2, [0], 1)
    same_columns(jout, tout)
    assert [c.name for c in tout] == [c.name for c in jout]


@pytest.mark.parametrize("op", ["sum", "min", "max", "avg", "count"])
@pytest.mark.parametrize("vdtype", [np.int64, np.float64, np.float32])
def test_group_by_entries(op, vdtype, rng):
    n = 400
    jk, tk = _named(*view(rng.integers(0, 30, n).astype(np.int32),
                          rng.random(n) < 0.1), "k")
    jj, tj = view(rng.integers(0, 3, n).astype(np.int64))
    jv, tv = view((rng.standard_normal(n) * 100).astype(vdtype),
                  rng.random(n) < 0.2)
    name = f"gdf_group_by_{op}"
    jkeys, jagg = getattr(jgdf, name)(2, [jk, jj], jv)
    tkeys, tagg = getattr(gdf, name)(2, [tk, tj], tv)
    same_columns(jkeys, tkeys)
    exact = op in ("min", "max", "count") or vdtype == np.int64 \
        and op == "sum"
    same(jagg, tagg, None if exact else
         (1e-12 if vdtype != np.float32 or op == "avg" else 1e-5))


def test_group_by_count_without_a_value_column():
    jk, tk = view(np.array([1, 2, 1, 2, 3], np.int32))
    jkeys, jagg = jgdf.gdf_group_by_count(1, [jk])
    tkeys, tagg = gdf.gdf_group_by_count(1, [tk])
    same_columns(jkeys, tkeys)
    same(jagg, tagg)
    assert np_of(tagg.data).tolist() == [2, 2, 1]


def test_order_by_entry(rng):
    ja, ta = view(rng.integers(0, 5, 100).astype(np.int32),
                  rng.random(100) < 0.2)
    jb, tb = view(rng.standard_normal(100))
    for asc, nl in ((True, True), (False, False)):
        same(jgdf.gdf_order_by([ja, jb], 2, None, asc, nl),
             gdf.gdf_order_by([ta, tb], 2, None, asc, nl))
    perm = gdf.gdf_order_by([view(np.array([3, 1, 2], np.int32))[1]])
    assert np_of(perm.data).tolist() == [1, 2, 0]
    assert perm.data.dtype == torch.int32 and perm.name == "indices"


def test_gdf_filter_value_tuple():
    ja, ta = view(np.array([1, 2, 1, 1], np.int32))
    jb, tb = view(np.array([5, 5, 6, 5], np.int32),
                  np.array([0, 0, 0, 1], bool))
    out = gdf.gdf_filter([ta, tb], (1, 5))
    same_columns(jgdf.gdf_filter([ja, jb], (1, 5)), out)
    assert np_of(out[0].data).tolist() == [1]


def test_radixsort_plan_lifecycle(rng):
    x = rng.integers(0, 1000, 128).astype(np.int32)
    v = np.arange(128, dtype=np.int32)
    (jx, tx), (jv, tv) = view(x), view(v)
    for desc, bits in ((False, (0, 0)), (True, (0, 0)), (False, (8, 24)),
                       (True, (3, 9))):
        jplan = jgdf.gdf_radixsort_plan(128, desc, *bits)
        plan = gdf.gdf_radixsort_plan(128, desc, *bits)
        with pytest.raises(GDFError):
            gdf.gdf_radixsort_i32(plan, tx)     # not set up yet
        jgdf.gdf_radixsort_plan_setup(jplan, 4, 4)
        assert gdf.gdf_radixsort_plan_setup(plan, 4, 4) is plan
        same_columns(jgdf.gdf_radixsort_i32(jplan, jx, jv),
                     gdf.gdf_radixsort_i32(plan, tx, tv))
        same_columns(jgdf.gdf_radixsort_generic(jplan, jx, jv),
                     gdf.gdf_radixsort_generic(plan, tx, tv))
    keys, vals = gdf.gdf_radixsort_i32(plan, tx, tv)
    with pytest.raises(GDFError):
        gdf.gdf_radixsort_i64(plan, tx, tv)
    gdf.gdf_radixsort_plan_free(plan)
    with pytest.raises(GDFError) as e:
        gdf.gdf_radixsort_i32(plan, tx)
    assert e.value.status == GDFStatus.GDF_INVALID_API_CALL


def test_segmented_radixsort_entry(rng):
    n = 500
    (jx, tx) = view(rng.integers(-1000, 1000, n))
    (jv, tv) = view(np.arange(n))
    offsets = np.asarray([0, 100, 250, 251, 400], np.int32)
    jplan = jgdf.gdf_segmented_radixsort_plan(n, True)
    plan = gdf.gdf_segmented_radixsort_plan(n, True)
    jgdf.gdf_segmented_radixsort_plan_setup(jplan)
    gdf.gdf_segmented_radixsort_plan_setup(plan)
    same_columns(
        jgdf.gdf_segmented_radixsort_i64(jplan, jx, jv, 5, offsets),
        gdf.gdf_segmented_radixsort_i64(plan, tx, tv, 5, offsets))
    gdf.gdf_segmented_radixsort_plan_free(plan)
    with pytest.raises(GDFError):
        gdf.gdf_segmented_radixsort_generic(plan, tx, tv, 5, offsets)


def test_hash_entries(rng):
    ja, ta = view(rng.integers(0, 100, 64).astype(np.int32),
                  rng.random(64) < 0.2)
    jb, tb = view(rng.standard_normal(64).astype(np.float32))
    same(jgdf.gdf_hash(2, [ja, jb]), gdf.gdf_hash(2, [ta, tb]))
    same(jgdf.gdf_hash(1, [ja, jb], "identity"),
         gdf.gdf_hash(1, [ta, tb], "identity"))
    same(jgdf.gpu_hash_columns([ja, jb]), gdf.gpu_hash_columns([ta, tb]))
    same(jgdf.gpu_hash_columns([ja, jb], 1), gdf.gpu_hash_columns([ta, tb], 1))
    jcols, joffs = jgdf.gdf_hash_partition(2, [ja, jb], [0], 4)
    tcols, toffs = gdf.gdf_hash_partition(2, [ta, tb], [0], 4)
    same_columns(jcols, tcols)
    np.testing.assert_array_equal(np_of(toffs), np_of(joffs))
    assert toffs.dtype == torch.int32


def test_quantile_entries(rng):
    jc, tc = view(rng.standard_normal(101), rng.random(101) < 0.2)
    for q in (0.0, 0.37, 1.0):
        for method in ("linear", "lower", "higher", "midpoint", "nearest"):
            assert float(gdf.gdf_quantile_exact(tc, q, method)) == \
                float(jgdf.gdf_quantile_exact(jc, q, method))
        assert float(gdf.gdf_quantile_aprrox(tc, q)) == \
            float(jgdf.gdf_quantile_aprrox(jc, q))


def test_nvtx_ranges_nest():
    gdf.gdf_nvtx_range_push("LIBGDF_JOIN", "green")
    gdf.gdf_nvtx_range_push_hex("inner", 0xff00ff)
    gdf.gdf_nvtx_range_pop()
    gdf.gdf_nvtx_range_pop()
    gdf.gdf_nvtx_range_pop()  # over-pop is a safe no-op


def test_nvtx_range_shows_in_a_profile():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gdf.gdf_nvtx_range_push("LIBGDF_TEST_RANGE")
        torch.arange(10).sum()
        gdf.gdf_nvtx_range_pop()
    assert any(e.key == "LIBGDF_TEST_RANGE" for e in prof.key_averages())


def test_error_introspection_and_context():
    assert gdf.gdf_error_get_name(GDFStatus.GDF_SUCCESS) == "GDF_SUCCESS"
    assert gdf.gdf_cuda_last_error() == 0
    for err in (0, 1):
        assert gdf.gdf_cuda_error_string(err) == \
            jgdf.gdf_cuda_error_string(err)
        assert gdf.gdf_cuda_error_name(err) == jgdf.gdf_cuda_error_name(err)
    ctx, jctx = gdf.gdf_context_view(1, 1, 0, 1), jgdf.gdf_context_view(
        1, 1, 0, 1)
    assert (ctx.flag_sorted, int(ctx.flag_method), ctx.flag_distinct,
            ctx.flag_sort_result) == (
        jctx.flag_sorted, int(jctx.flag_method), jctx.flag_distinct,
        jctx.flag_sort_result)


@pytest.mark.parametrize("reduction,frame,preceding", [
    (WindowReductionType.GDF_WINDOW_SUM, WindowFunctionType.GDF_WINDOW_ROW, 5),
    ("max", "row", 7), (0, 0, 20), ("count", "RANGE", 3.5)])
def test_gdf_window_function_abi_enums(reduction, frame, preceding, rng):
    n = 200
    jv, tv = _named(*view(rng.standard_normal(n), rng.random(n) < 0.1), "v")
    jo, to = _named(*view(rng.permutation(n).astype(np.int32)), "o")
    jp, tp = _named(*view(rng.integers(0, 3, n).astype(np.int32)), "p")
    jred = reduction if isinstance(reduction, (str, int)) and not isinstance(
        reduction, WindowReductionType) else int(reduction)
    jfrm = frame if isinstance(frame, str) else int(frame)
    jout = jgdf.gdf_window_function(jv, jred, jfrm, preceding=preceding,
                                    partition_columns=[jp],
                                    order_columns=[jo])
    tout = gdf.gdf_window_function(tv, reduction, frame, preceding=preceding,
                                   partition_columns=[tp],
                                   order_columns=[to])
    assert tout.name == jout.name
    same(jout, tout, rtol=1e-12)


def test_gdf_window_function_unknown_names_raise_gdf_error():
    """An unknown frame or reduction, by name or by value, is
    GDF_INVALID_API_CALL (the JAX package lets a KeyError through)."""
    _, tv = view(np.arange(4.0))
    for red, frame in (("sum", "rows_between"), ("median", "row"),
                       (1, 7), (99, 1)):
        with pytest.raises(GDFError) as e:
            gdf.gdf_window_function(tv, red, frame, preceding=2)
        assert e.value.status == GDFStatus.GDF_INVALID_API_CALL
    with pytest.raises(KeyError):
        jgdf.gdf_window_function(view(np.arange(4.0))[0], "sum",
                                 "rows_between", preceding=2)


def test_io_and_rmm_entries(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text("1,2.5\n,3.5\n")
    from libgdf_tpu_torch.io import CSVReadArg
    t = gdf.read_csv(CSVReadArg(file_path=str(p), names=["a", "b"],
                                dtype=["int64", "float64"]), device="cpu")
    assert np_of(t["a"].valid).tolist() == [True, False]
    h = gdf.gdf_ipc_parser_open(b"junk", device="cpu")
    assert gdf.gdf_ipc_parser_failed(h) == 1
    assert gdf.rmmInitialize() == 0 and gdf.rmmIsInitialized()
    assert gdf.rmmGetErrorString(4) == "RMM_ERROR_OUT_OF_MEMORY"
    assert gdf.rmmFinalize() == 0


def test_abi_pipeline_matches(rng):
    """view -> compare -> stencil -> join -> group_by -> order_by ->
    radixsort -> prefixsum -> csr through both packages."""
    n, m = 4000, 500
    key = rng.integers(0, m, n)
    i32 = rng.integers(-1000, 1000, n).astype(np.int32)
    f64 = rng.standard_normal(n)
    results = []
    for g, mk in ((jgdf, lambda d, v=None: jgdf.gdf_column_view(d, v)),
                  (gdf, lambda d, v=None: gdf.gdf_column_view(
                      d, v, device="cpu"))):
        k = mk(key, np.random.default_rng(1).random(n) >= 0.05).with_name("k")
        a = mk(i32).with_name("a")
        x = mk(f64, np.random.default_rng(2).random(n) >= 0.1).with_name("x")
        stencil = g.gpu_comparison_static_i64(k, m // 2, "lt")
        kept = [g.gpu_apply_stencil(c, stencil) for c in (k, a, x)]
        dk = mk(np.random.default_rng(3).permutation(m)).with_name("k")
        dw = mk(np.random.default_rng(4).integers(0, 9, m)).with_name("w")
        joined = g.gdf_inner_join(kept, 3, [0], [dk, dw], 2, [0], 1)
        byname = {c.name: c for c in joined}
        keys, total = g.gdf_group_by_sum(1, [byname["w"]], byname["x"])
        _, top = g.gdf_group_by_max(1, [byname["w"]], byname["k"])
        order = g.gdf_order_by([total], 1, None, False, True)
        plan = g.gdf_radixsort_plan(joined[0].size, False, 8, 24)
        g.gdf_radixsort_plan_setup(plan)
        sk, sv = g.gdf_radixsort_i32(plan, byname["a"], byname["k"])
        ps = g.gdf_prefixsum_i32(sk.with_valid(None))
        csr = g.gdf_to_csr([byname["x"], g.gdf_cast_i32_to_f64(
            byname["a"])])
        results.append(dict(kept=kept, joined=joined, keys=keys,
                            total=total, top=top, order=order, sk=sk,
                            sv=sv, ps=ps, csr=csr))
    j, t = results
    same_columns(j["kept"], t["kept"])
    same_columns(j["joined"], t["joined"])
    assert t["joined"][0].size > 1000
    same_columns(j["keys"], t["keys"])
    same(j["total"], t["total"], rtol=1e-12)
    same(j["top"], t["top"])
    same(j["sk"], t["sk"])
    same(j["sv"], t["sv"])
    same(j["ps"], t["ps"])
    jc, tc = j["csr"], t["csr"]
    assert int(tc.nnz) == int(jc.nnz) and (tc.rows, tc.cols) == (
        jc.rows, jc.cols)
    for f in ("A", "IA", "JA"):
        np.testing.assert_array_equal(np_of(getattr(tc, f)),
                                      np_of(getattr(jc, f)))
    # the sums differ in the last bits at most, so the orders agree where
    # the sums are apart
    np.testing.assert_array_equal(np_of(t["order"].data),
                                  np_of(j["order"].data))
