"""libgdf_tpu_torch core against libgdf_tpu core, on the CPU.

Everything here is exact: enum members, null masks, values, live masks.
"""
import ast
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libgdf_tpu
from libgdf_tpu.core import bitmask as jbitmask
from libgdf_tpu.core import context as jcontext
from libgdf_tpu.core import bits as jbits
from libgdf_tpu.core import dtypes as jdtypes
from libgdf_tpu.core import errors as jerrors
from libgdf_tpu_torch import Column, Table, ops
from libgdf_tpu_torch import column_concat, table_concat
from libgdf_tpu_torch.core import bitmask, bits, context, dtypes, errors
from libgdf_tpu_torch.interop import from_numpy, to_numpy
from torch_parity import (assert_tables_match, jax_to_numpy, make_tables,
                          np_of)

PORT = pathlib.Path(__file__).resolve().parents[1] / "libgdf_tpu_torch"


@pytest.mark.parametrize("enum_name,module_pair", [
    ("GDFStatus", (jerrors, errors)),
    ("GDFDtype", (jdtypes, dtypes)),
    ("TimeUnit", (jdtypes, dtypes)),
    ("WindowFunctionType", (jdtypes, dtypes)),
    ("WindowReductionType", (jdtypes, dtypes)),
    ("Method", (jcontext, context)),
])
def test_copied_enums_pinned(enum_name, module_pair):
    ref, port = (getattr(m, enum_name) for m in module_pair)
    assert [(e.name, e.value) for e in port] == \
        [(e.name, e.value) for e in ref]


def test_errors_behave_alike():
    for code in (0, 9, 17, 99):
        assert errors.error_get_name(code) == jerrors.error_get_name(code)
    a = errors.GDFError(errors.GDFStatus.GDF_DTYPE_MISMATCH, "x")
    b = jerrors.GDFError(jerrors.GDFStatus.GDF_DTYPE_MISMATCH, "x")
    assert str(a) == str(b)
    with pytest.raises(errors.GDFError):
        errors.require(False, errors.GDFStatus.GDF_C_ERROR)


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|libgdf_tpu)(\.|\s|$)",
                        re.M)


def test_port_imports_no_jax():
    """No module of the port imports jax or libgdf_tpu (importing any
    libgdf_tpu module imports jax and turns on x64)."""
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        src = path.read_text()
        assert not _FORBIDDEN.search(src), path
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [node.module.split(".")[0]]
            else:
                continue
            assert not {"jax", "libgdf_tpu"} & set(roots), (path, roots)


COLUMNS = {
    "i32": np.array([3, -1, 7, 0, 2], np.int32),
    "i64": np.array([1 << 40, -5, 0, 9, 2], np.int64),
    "f32": np.array([1.5, -0.0, np.nan, 2.0, -3.25], np.float32),
    "f64": np.array([1e300, -2.0, 0.5, np.inf, -np.inf], np.float64),
    "u32": np.array([0, 1, 2**32 - 1, 7, 2**31], np.uint32),
    "b": np.array([True, False, True, True, False]),
}
NULLS = {"i32": np.array([0, 1, 0, 0, 1], bool),
         "f32": np.array([1, 0, 0, 0, 0], bool)}


def test_interop_round_trip_matches_jax():
    jt, tt = make_tables(COLUMNS, NULLS)
    jv, jn = jax_to_numpy(jt)
    tv, tn = to_numpy(tt)
    assert list(jv) == list(tv)
    for name in jv:
        assert tv[name].dtype == jv[name].dtype, name
        np.testing.assert_array_equal(tv[name], jv[name])
        np.testing.assert_array_equal(tn[name], jn[name])
        assert tt[name].info.gdf_dtype.value == jt[name].info.gdf_dtype.value


def test_from_dict_accepts_tensors_and_keeps_device():
    t = Table.from_dict({"a": torch.arange(4, dtype=torch.int32)},
                        nulls={"a": torch.tensor([0, 1, 0, 0],
                                                 dtype=torch.bool)})
    assert t.device.type == "cpu" and t["a"].data.dtype == torch.int32
    assert t["a"].valid.tolist() == [True, False, True, True]
    assert int(t["a"].null_count()) == 1


def test_host_data_goes_to_the_card_by_default(monkeypatch):
    """With `device` omitted, numpy data is meant for the card: where there
    is none the constructors raise and name device="cpu"; they never hand
    back CPU tensors. A tensor stays on its own device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cols = {"a": np.arange(4, dtype=np.int32)}
    for build in (lambda: from_numpy(cols),
                  lambda: Table.from_dict(cols),
                  lambda: Column.from_array(cols["a"]),
                  lambda: Column.from_masked(cols["a"], np.zeros(4, bool))):
        with pytest.raises(errors.GDFError, match="device='cpu'"):
            build()
    t = from_numpy(cols, {"a": np.array([0, 1, 0, 0], bool)}, device="cpu")
    assert t.device.type == "cpu" and t["a"].valid.device.type == "cpu"
    c = Column.from_masked(torch.arange(3), np.array([0, 1, 0], bool))
    assert c.device.type == "cpu" and c.valid.tolist() == [True, False, True]


@pytest.mark.parametrize("num_rows", [0, 3, 5])
def test_live_mask_row_validity_compact(num_rows):
    jt, tt = make_tables(COLUMNS, NULLS, num_rows=num_rows)
    np.testing.assert_array_equal(tt.live_mask().numpy(),
                                  np.asarray(jt.live_mask()))
    np.testing.assert_array_equal(tt.row_validity().numpy(),
                                  np.asarray(jt.row_validity()))
    assert tt.num_rows.dtype == torch.int32 and tt.num_rows.dim() == 0
    jc, tc = jt.compact(), tt.compact()
    assert tc.num_rows is None and tc.capacity == jc.capacity == num_rows
    values, _ = to_numpy(tt)
    np.testing.assert_array_equal(values["i64"], COLUMNS["i64"][:num_rows])


@pytest.mark.parametrize("n", [0, 1, 8, 13, 64])
def test_bitmask_pack_unpack(n):
    rng = np.random.default_rng(n)
    v = rng.random(n) < 0.5
    packed = bitmask.pack_bool_mask(torch.as_tensor(v))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jbitmask.pack_bool_mask(jnp.asarray(v))))
    np.testing.assert_array_equal(bitmask.unpack_bitmask(packed, n).numpy(),
                                  v)
    col = Column.from_array(np.arange(n, dtype=np.int32), valid=packed,
                            device="cpu")
    if n % 8:
        np.testing.assert_array_equal(col.valid.numpy(), v)


def test_f64_bits_canonicalized_like_jax():
    x = np.array([0.0, -0.0, 1.0, -1.5, np.nan, -np.nan, np.inf, -np.inf,
                  1e-310, -1e-310, 2.0 ** -1022, 1e308], np.float64)
    got = bits.f64_ieee_bits(torch.as_tensor(x)).numpy().view(np.uint64)
    want = np.asarray(jbits.f64_ieee_bits(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def test_context_is_the_jax_packages_module():
    """core/context.py imports no JAX, so the port keeps a verbatim copy
    (importing the original would import JAX with its package)."""
    assert pathlib.Path(context.__file__).read_text() == \
        pathlib.Path(jcontext.__file__).read_text()
    ctx = context.context_view(1, context.Method.HASH, 0, 1)
    assert (ctx.flag_sorted, ctx.flag_method, ctx.flag_distinct,
            ctx.flag_sort_result, ctx.flag_sort_inplace) == \
        (True, context.Method.HASH, False, True, False)
    assert context.Context() == context.context_view()


def test_dtype_info_properties_and_byte_width():
    for g in dtypes.GDFDtype:
        jg = jdtypes.GDFDtype(g.value)
        info, jinfo = dtypes.DtypeInfo(g), jdtypes.DtypeInfo(jg)
        assert info.is_floating == jinfo.is_floating
        assert info.is_datetime == jinfo.is_datetime
        if g in (dtypes.GDFDtype.invalid, dtypes.GDFDtype.STRING):
            with pytest.raises(TypeError):
                dtypes.byte_width(g)
            continue
        assert dtypes.byte_width(g) == jdtypes.byte_width(jg) == \
            info.byte_width == info.physical.itemsize


def test_bitmask_count_concat_all_on():
    v = np.array([1, 0, 1, 1, 0], bool)
    assert int(bitmask.count_valid(torch.as_tensor(v), 5)) == \
        int(jbitmask.count_valid(jnp.asarray(v), 5)) == 3
    got = bitmask.count_valid(None, 7)
    assert int(got) == 7 and got.dtype == torch.int32
    np.testing.assert_array_equal(
        bitmask.mask_concat([torch.as_tensor(v), None, torch.as_tensor(v)],
                            [5, 2, 3]).numpy(),
        np.asarray(jbitmask.mask_concat([jnp.asarray(v), None,
                                         jnp.asarray(v)], [5, 2, 3])))
    assert bitmask.mask_concat([None], [3], device="cpu").tolist() == \
        [True] * 3
    on = bitmask.all_bitmask_on(9, device="cpu")
    assert on.dtype == torch.bool and on.tolist() == [True] * 9


def test_column_introspection_and_interchange():
    jt, tt = make_tables(COLUMNS, NULLS)
    for name in COLUMNS:
        jc, tc = jt[name], tt[name]
        assert tc.gdf_dtype.value == jc.gdf_dtype.value
        assert tc.has_nulls == jc.has_nulls == (name in NULLS)
        jv, jn = jc.to_numpy_masked()
        tv, tn = tc.to_numpy_masked()
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tn, jn)
        if tc.has_nulls:
            np.testing.assert_array_equal(tc.packed_bitmask().numpy(),
                                          np.asarray(jc.packed_bitmask()))
        else:
            assert tc.packed_bitmask() is None


def test_column_and_table_concat():
    jt, tt = make_tables(COLUMNS, NULLS)
    for name in ("i32", "f64"):
        jc = libgdf_tpu.column_concat([jt[name], jt[name]])
        tc = column_concat([tt[name], tt[name]])
        assert (tc.valid is None) == (jc.valid is None)
        np.testing.assert_array_equal(np_of(tc.data), np_of(jc.data))
        assert tc.name == jc.name and tc.size == 10
    _, plain = make_tables({"i32": COLUMNS["i32"]})
    mixed = column_concat([plain["i32"], tt["i32"]])
    assert mixed.valid.tolist() == [True] * 5 + (~NULLS["i32"]).tolist()
    assert_tables_match(libgdf_tpu.table_concat([jt, jt, jt]),
                        table_concat([tt, tt, tt]))
    with pytest.raises(errors.GDFError):
        column_concat([])
    with pytest.raises(errors.GDFError):
        column_concat([tt["i32"], tt["i64"]])
    with pytest.raises(errors.GDFError):
        table_concat([tt, tt.with_num_rows(2)])
    with pytest.raises(errors.GDFError):
        table_concat([tt, tt.select(["i32"])])


def test_table_select_replace_with_column_row_count():
    jt, tt = make_tables(COLUMNS, NULLS)
    assert_tables_match(jt.select(["f32", "i32"]), tt.select(["f32", "i32"]))
    assert tt.row_count() == jt.row_count() == 5
    assert int(tt.with_num_rows(3).row_count()) == 3
    jr = jt.replace_column("i32", jt["i64"])
    tr = tt.replace_column("i32", tt["i64"])
    assert tr.names == jr.names and tr["i32"].name == "i32"
    assert_tables_match(jr, tr)
    jw = jt.with_column(jt["b"].with_name("z")).with_column(
        jt["i64"].with_name("i32"))
    tw = tt.with_column(tt["b"].with_name("z")).with_column(
        tt["i64"].with_name("i32"))
    assert tw.names == jw.names
    assert_tables_match(jw, tw)


@pytest.mark.parametrize("fill_invalid", [False, True])
def test_table_gather_scatter_rows_equal(fill_invalid):
    jt, tt = make_tables(COLUMNS, NULLS)
    idx = np.array([4, 0, -1, 7, 2, 2], np.int32)
    assert_tables_match(jt.gather(idx, fill_invalid=fill_invalid),
                        tt.gather(idx, fill_invalid=fill_invalid))
    assert_tables_match(
        jt.gather(idx, fill_invalid=fill_invalid, num_rows=4),
        tt.gather(torch.as_tensor(idx), fill_invalid=fill_invalid,
                  num_rows=4))
    loc = np.array([6, 0, 3, 1, 4], np.int32)
    js, ts = jt.scatter(loc, out_capacity=8), tt.scatter(loc, out_capacity=8)
    assert_tables_match(js, ts)
    for name in js.names:      # untouched rows too
        np.testing.assert_array_equal(np_of(ts[name].data),
                                      np_of(js[name].data))
    a, b = np.array([0, 1, 2, 3, 4, 2]), np.array([0, 1, 2, 4, 4, 2])
    np.testing.assert_array_equal(
        np_of(tt.rows_equal(tt, a, b)),
        np_of(jt.rows_equal(jt, jnp.asarray(a), jnp.asarray(b))))


def test_table_pandas_round_trip():
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame({"a": [1.5, None, 3.0], "b": [1, 2, 3],
                       "c": pd.array([1, None, 3], dtype="Int64")})
    jt = libgdf_tpu.Table.from_pandas(df[["a", "b"]])
    tt = Table.from_pandas(df[["a", "b"]], device="cpu")
    assert_tables_match(jt, tt)
    back = tt.to_pandas()
    assert back["b"].tolist() == [1, 2, 3]
    assert back["a"].isna().tolist() == [False, True, False]
    pd.testing.assert_frame_equal(back, jt.to_pandas())


def test_tracing_ranges_and_colors():
    from libgdf_tpu.utils import tracing as jtracing
    from libgdf_tpu_torch.utils import tracing
    for name in dir(jtracing):
        if name.startswith("GDF_"):
            assert getattr(tracing, name) == getattr(jtracing, name)
    tracing.range_pop()                      # nothing open: a no-op
    with tracing.op_range("LIBGDF_JOIN", tracing.GDF_BLUE):
        tracing.range_push_hex("inner", 0xff)
        tracing.range_pop()
    assert tracing._ranges() == []
