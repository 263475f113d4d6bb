"""libgdf_tpu_torch I/O against libgdf_tpu's, on the CPU: CSV ingest (the
native scanner and the Python scan), Arrow IPC, CSR conversion. Columns,
null masks, category dictionaries, CSR arrays and the IPC schema / layout
JSON are all exact."""
import json

import numpy as np
import pytest
import torch

import libgdf_tpu
from libgdf_tpu import io as jio
from libgdf_tpu_torch import GDFDtype, GDFError, Table, TimeUnit, io, native
from libgdf_tpu_torch.io import CSVReadArg, gdf_to_csr, read_csv
from libgdf_tpu_torch.io import ipc as ipc_mod
from torch_parity import assert_tables_match, make_tables, np_of

SIMPLE = ("0,0.0,10,a\n"
          "1,1.5,,b\n"
          "2,-2.25,30,\n"
          "3,,40,a\n"
          ",4.75,50,c\n")
NAMES = ["a", "b", "c", "s"]
DTYPES = ["int32", "float64", "int64", "str"]


@pytest.fixture
def csv_file(tmp_path):
    p = tmp_path / "simple.csv"
    p.write_text(SIMPLE)
    return str(p)


@pytest.fixture
def python_scanner(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load", lambda: None)


def read_both(**kw):
    jt = jio.read_csv(jio.CSVReadArg(**kw))
    arg = CSVReadArg(**kw)
    tt = read_csv(arg, device="cpu")
    assert arg.num_rows_out == tt.capacity
    assert arg.num_cols_out == len(kw["names"])
    assert [c.name for c in arg.data] == list(kw["names"])
    assert_tables_match(jt, tt)
    for name in tt.names:
        assert tt[name].info.gdf_dtype.value == jt[name].info.gdf_dtype.value
        assert tt[name].info.time_unit.value == jt[name].info.time_unit.value
    assert tt.categories == jt.categories
    return tt, arg


def _check_simple(t: Table):
    a, an = t["a"].to_numpy_masked()
    b, bn = t["b"].to_numpy_masked()
    c, cn = t["c"].to_numpy_masked()
    np.testing.assert_array_equal(an, [0, 0, 0, 0, 1])
    np.testing.assert_array_equal(a[:4], [0, 1, 2, 3])
    np.testing.assert_array_equal(bn, [0, 0, 0, 1, 0])
    np.testing.assert_array_equal(b[[0, 1, 2, 4]], [0.0, 1.5, -2.25, 4.75])
    np.testing.assert_array_equal(cn, [0, 1, 0, 0, 0])
    np.testing.assert_array_equal(c[[0, 2, 3, 4]], [10, 30, 40, 50])


def test_native_scanner_builds_from_the_checkout():
    """The scanner is compiled from native/csvparse.cpp into build/native/
    at first use; the committed binary of the JAX package is not loaded."""
    assert native.csv_scan_available()
    path = native.library_path()
    assert path.exists() and path.parent.name == "native"
    assert path.parent.parent.name == "build"


def test_read_csv_native(csv_file):
    t, arg = read_both(file_path=csv_file, names=NAMES, dtype=DTYPES)
    assert arg.scanner == "native"
    assert arg.num_rows_out == 5 and arg.num_cols_out == 4
    _check_simple(t)
    s, sn = t["s"].to_numpy_masked()
    np.testing.assert_array_equal(sn, [0, 0, 1, 0, 0])
    cats = t.categories["s"]
    assert [cats[i] for i in s[[0, 1, 3, 4]]] == ["a", "b", "a", "c"]
    assert t["s"].info.gdf_dtype == GDFDtype.CATEGORY


def test_read_csv_python_fallback(csv_file, python_scanner):
    t, arg = read_both(file_path=csv_file, names=NAMES, dtype=DTYPES)
    assert arg.scanner == "python"
    _check_simple(t)


def test_read_csv_scanners_agree(tmp_path, monkeypatch, rng):
    """A few thousand rows with empty fields through both scanners."""
    n = 3000
    k = rng.integers(-2**40, 2**40, n)
    v = rng.integers(-1000, 1000, n)
    x = rng.standard_normal(n)
    s = rng.integers(0, 50, n)
    hole = rng.random((n, 4)) < 0.03
    lines = []
    for i in range(n):
        f = [str(k[i]), str(v[i]), repr(float(x[i])), f"w{s[i]:02d}"]
        lines.append(",".join("" if hole[i, j] else f[j] for j in range(4)))
    p = tmp_path / "big.csv"
    p.write_text("\n".join(lines) + "\n")
    kw = dict(file_path=str(p), names=["k", "v", "x", "s"],
              dtype=["int64", "int32", "float64", "str"])
    t_native, arg = read_both(**kw)
    assert arg.scanner == "native"
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load", lambda: None)
    t_python, arg = read_both(**kw)
    assert arg.scanner == "python"
    for name in t_native.names:
        a, an = t_native[name].to_numpy_masked()
        b, bn = t_python[name].to_numpy_masked()
        np.testing.assert_array_equal(an, bn)
        np.testing.assert_array_equal(a[~an], b[~bn])
    kv, kn = t_native["k"].to_numpy_masked()
    np.testing.assert_array_equal(kn, hole[:, 0])
    np.testing.assert_array_equal(kv[~kn], k[~kn])
    xv, xn = t_native["x"].to_numpy_masked()
    np.testing.assert_array_equal(xv[~xn], x[~xn])


def test_read_csv_dates(tmp_path):
    pytest.importorskip("pandas")
    p = tmp_path / "dates.csv"
    p.write_text("2019-01-01,01/02/2003,1969-12-31 23:59:59\n"
                 "1970-01-02,,2001-02-03\n")
    t, _ = read_both(file_path=str(p), names=["d", "e", "f"],
                     dtype=["date32", "date64", "timestamp"], dayfirst=True)
    d, dn = t["d"].to_numpy_masked()
    assert dn.sum() == 0 and d[1] == 1
    assert t["d"].info.gdf_dtype == GDFDtype.DATE32
    e, en = t["e"].to_numpy_masked()
    np.testing.assert_array_equal(en, [0, 1])
    import pandas as pd
    assert e[0] == int(pd.Timestamp("2003-02-01").value // 1_000_000)
    assert t["f"].info.time_unit == TimeUnit.ms
    assert t["f"].to_numpy_masked()[0][0] == -1000


@pytest.mark.parametrize("scanner", ["native", "python"])
def test_read_csv_options(tmp_path, scanner, monkeypatch):
    if scanner == "python":
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_load", lambda: None)
    p = tmp_path / "opt.csv"
    p.write_text("# header\n1| 2\n3|4\n5|6\n# trailer\n")
    t, arg = read_both(file_path=str(p), delimiter="|", skiprows=1,
                       skipfooter=1, skipinitialspace=True,
                       names=["x", "y"], dtype=["int32", "int32"])
    assert arg.scanner == scanner
    np.testing.assert_array_equal(np_of(t["x"].data), [1, 3, 5])
    np.testing.assert_array_equal(np_of(t["y"].data), [2, 4, 6])


def test_read_csv_whitespace_delimited_uses_the_python_scan(tmp_path):
    p = tmp_path / "ws.csv"
    p.write_text("1   2.5\n3 4.5\n")
    t, arg = read_both(file_path=str(p), delim_whitespace=True,
                       names=["x", "y"], dtype=["int64", "float32"])
    assert arg.scanner == "python"
    np.testing.assert_array_equal(np_of(t["x"].data), [1, 3])


def test_read_csv_errors(tmp_path, python_scanner):
    with pytest.raises(GDFError):
        read_csv(CSVReadArg(names=["a"], dtype=["int32"]), device="cpu")
    with pytest.raises(GDFError):
        read_csv(CSVReadArg(file_path=str(tmp_path / "none.csv"),
                            names=["a"], dtype=["int32"]), device="cpu")
    with pytest.raises(GDFError):
        read_csv(CSVReadArg(file_path="x", names=["a"], dtype=[]),
                 device="cpu")
    with pytest.raises(GDFError):
        io.dtype_from_string("complex")
    for s in ("str", "date", "float", "double", "long", "short", "int8"):
        assert io.dtype_from_string(s).value == \
            jio.dtype_from_string(s).value


def test_read_csv_goes_to_the_card_by_default(csv_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(GDFError, match="device='cpu'"):
        read_csv(CSVReadArg(file_path=csv_file, names=NAMES, dtype=DTYPES))


def _ipc_stream(pa, batch):
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, batch.schema) as w:
        w.write_batch(batch)
    stream = sink.getvalue().to_pybytes()
    first = pa.ipc.read_message(pa.BufferReader(stream))
    n = first.serialize().size
    return stream[:n], stream[n:]


def _ipc_both(schema, rb):
    jh = jio.ipc.gdf_ipc_parser_open(schema)
    th = ipc_mod.gdf_ipc_parser_open(schema, device="cpu")
    assert not ipc_mod.gdf_ipc_parser_failed(th), \
        ipc_mod.gdf_ipc_parser_get_error(th)
    assert ipc_mod.gdf_ipc_parser_get_schema_json(th) == \
        jio.ipc.gdf_ipc_parser_get_schema_json(jh)
    jio.ipc.gdf_ipc_parser_open_recordbatches(jh, rb)
    ipc_mod.gdf_ipc_parser_open_recordbatches(th, rb, len(rb))
    assert not ipc_mod.gdf_ipc_parser_failed(th), \
        ipc_mod.gdf_ipc_parser_get_error(th)
    assert ipc_mod.gdf_ipc_parser_get_layout_json(th) == \
        jio.ipc.gdf_ipc_parser_get_layout_json(jh)
    assert ipc_mod.gdf_ipc_parser_to_json(th) == \
        jio.ipc.gdf_ipc_parser_to_json(jh)
    assert ipc_mod.gdf_ipc_parser_get_data_offset(th) == \
        jio.ipc.gdf_ipc_parser_get_data_offset(jh)
    assert ipc_mod.gdf_ipc_parser_get_data(th) == rb
    assert_tables_match(jh.to_table(), th.to_table())
    assert ipc_mod.gdf_ipc_parser_close(th) is None
    return th


def test_ipc_roundtrip(rng):
    pa = pytest.importorskip("pyarrow")
    a = rng.integers(0, 100, 32).astype(np.int64)
    b = rng.standard_normal(32)
    mask = rng.random(32) < 0.25
    batch = pa.record_batch({
        "a": pa.array(a),
        "b": pa.array(np.where(mask, np.nan, b), mask=mask)})
    handle = _ipc_both(*_ipc_stream(pa, batch))
    schema = json.loads(ipc_mod.gdf_ipc_parser_get_schema_json(handle))
    assert [f["name"] for f in schema["fields"]] == ["a", "b"]
    layout = json.loads(ipc_mod.gdf_ipc_parser_get_layout_json(handle))
    assert layout["columns"][0]["length"] == 32
    assert layout["columns"][1]["null_count"] == int(mask.sum())
    t = handle.to_table()
    assert t.device.type == "cpu"
    np.testing.assert_array_equal(np_of(t["a"].data), a)
    bv, bn = t["b"].to_numpy_masked()
    np.testing.assert_array_equal(bn, mask)
    np.testing.assert_array_equal(bv[~mask], b[~mask])


def test_ipc_bad_schema():
    handle = ipc_mod.gdf_ipc_parser_open(b"not arrow data", device="cpu")
    assert ipc_mod.gdf_ipc_parser_failed(handle)
    assert ipc_mod.gdf_ipc_parser_get_error(handle)
    assert ipc_mod.gdf_ipc_parser_get_schema_json(handle) == "{}"
    assert ipc_mod.gdf_ipc_parser_get_layout_json(handle) == "{}"
    with pytest.raises(GDFError):
        handle.to_table()


def test_ipc_layout_offsets(rng):
    pa = pytest.importorskip("pyarrow")
    a = rng.integers(0, 1 << 30, 64).astype(np.int32)
    mask = rng.random(64) < 0.3
    b = rng.standard_normal(64)
    batch = pa.record_batch({
        "a": pa.array(a),
        "b": pa.array(np.where(mask, np.nan, b), mask=mask)})
    schema, rb = _ipc_stream(pa, batch)
    handle = _ipc_both(schema, rb)
    layout = json.loads(ipc_mod.gdf_ipc_parser_get_layout_json(handle))
    base = ipc_mod.gdf_ipc_parser_get_data_offset(handle)
    assert base > 0
    da = layout["columns"][0]["data_buffer"]
    got = np.frombuffer(rb, np.int32, count=64, offset=base + da["offset"])
    np.testing.assert_array_equal(got, a)
    nb = layout["columns"][1]["null_buffer"]
    bits = np.unpackbits(
        np.frombuffer(rb, np.uint8, count=8, offset=base + nb["offset"]),
        bitorder="little")[:64]
    np.testing.assert_array_equal(bits.astype(bool), ~mask)


def _csr_both(cols, nulls):
    jt, tt = make_tables(cols, nulls)
    want = jio.gdf_to_csr(jt.columns)
    got = gdf_to_csr(tt.columns)
    assert (got.rows, got.cols) == (want.rows, want.cols)
    assert got.dtype.value == want.dtype.value
    nnz = int(got.nnz)
    assert nnz == int(want.nnz)
    assert got.IA.dtype == torch.int32 and got.JA.dtype == torch.int64
    np.testing.assert_array_equal(np_of(got.IA), np_of(want.IA))
    np.testing.assert_array_equal(np_of(got.JA), np_of(want.JA))
    np.testing.assert_array_equal(np_of(got.A), np_of(want.A))
    return got, nnz


def test_gdf_to_csr():
    cols = {"a": np.array([1.0, 0.5, 2.0]), "b": np.array([3.0, 4.0, 5.0])}
    nulls = {"a": np.array([False, True, False]),
             "b": np.array([True, False, False])}
    csr, nnz = _csr_both(cols, nulls)
    assert (csr.rows, csr.cols, nnz) == (3, 2, 4)
    np.testing.assert_array_equal(np_of(csr.IA), [0, 1, 2, 4])
    np.testing.assert_array_equal(np_of(csr.JA)[:nnz], [0, 1, 0, 1])
    np.testing.assert_array_equal(np_of(csr.A)[:nnz], [1.0, 4.0, 2.0, 5.0])


@pytest.mark.parametrize("dtype", [np.float32, np.int64])
def test_gdf_to_csr_random(dtype, rng):
    n = 700
    cols = {f"c{j}": (rng.standard_normal(n) * 10).astype(dtype)
            for j in range(4)}
    nulls = {"c0": rng.random(n) < 0.5, "c2": rng.random(n) < 0.9,
             "c3": np.ones(n, bool)}
    _csr_both(cols, nulls)


def test_gdf_to_csr_rejects_mixed_dtypes_and_counts_columns():
    _, tt = make_tables({"a": np.ones(3, np.float32),
                         "b": np.ones(3, np.float64)})
    with pytest.raises(GDFError):
        gdf_to_csr(tt.columns)
    assert gdf_to_csr(tt.columns, num_cols=1).cols == 1
