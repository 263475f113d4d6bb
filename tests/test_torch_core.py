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

from libgdf_tpu.core import bitmask as jbitmask
from libgdf_tpu.core import bits as jbits
from libgdf_tpu.core import dtypes as jdtypes
from libgdf_tpu.core import errors as jerrors
from libgdf_tpu_torch import Column, Table, ops
from libgdf_tpu_torch.core import bitmask, bits, dtypes, errors
from libgdf_tpu_torch.interop import from_numpy, to_numpy
from libgdf_tpu_torch.utils import metrics
from torch_parity import jax_to_numpy, make_tables

PORT = pathlib.Path(__file__).resolve().parents[1] / "libgdf_tpu_torch"


@pytest.mark.parametrize("enum_name,module_pair", [
    ("GDFStatus", (jerrors, errors)),
    ("GDFDtype", (jdtypes, dtypes)),
    ("TimeUnit", (jdtypes, dtypes)),
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


def test_metrics_record_filter_events():
    metrics.reset()
    metrics.enable(True)
    try:
        t = from_numpy({"a": np.arange(10, dtype=np.int32)}, device="cpu")
        ops.filter_table(t, ops.compare_scalar(t["a"], 4, "lt"))
    finally:
        metrics.enable(False)
    (ev,) = metrics.events()
    assert (ev.name, ev.rows_in, ev.rows_out) == ("LIBGDF_FILTER", 10, 4)
    assert metrics.write_log().splitlines()[0].startswith("op,rows_in")
    metrics.reset()
