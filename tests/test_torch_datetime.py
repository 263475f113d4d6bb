"""libgdf_tpu_torch datetime extraction against libgdf_tpu's, on the CPU.

Every field of every datetime dtype and unit, pre-1970 values included;
all exact (the outputs are INT16 fields)."""
import jax
import numpy as np
import pytest

import libgdf_tpu
from libgdf_tpu import ops as jops
from libgdf_tpu_torch import Column, GDFDtype, GDFError, TimeUnit, ops
from torch_parity import np_of

FIELDS = ("year", "month", "day", "hour", "minute", "second")
# ticks per second of each TIMESTAMP unit
UNIT_SCALE = {TimeUnit.s: 1, TimeUnit.ms: 1000, TimeUnit.us: 10**6,
              TimeUnit.ns: 10**9, TimeUnit.NONE: 1000}


def both(values, gdf_dtype, time_unit=TimeUnit.NONE, null=None):
    jkw = dict(gdf_dtype=getattr(libgdf_tpu.GDFDtype, gdf_dtype.name),
               time_unit=getattr(libgdf_tpu.TimeUnit, time_unit.name))
    tkw = dict(gdf_dtype=gdf_dtype, time_unit=time_unit, device="cpu")
    valid = None if null is None else ~null
    return (libgdf_tpu.Column.from_array(values, valid=valid, **jkw),
            Column.from_array(values, valid=valid, **tkw))


def assert_field_matches(field, jc, tc):
    want = jax.jit(getattr(jops, f"extract_{field}"))(jc)
    got = getattr(ops, f"extract_{field}")(tc)
    assert got.info.gdf_dtype == GDFDtype.INT16
    assert np_of(got.data).dtype == np.int16
    np.testing.assert_array_equal(np_of(got.data), np_of(want.data))
    assert (got.valid is None) == (want.valid is None)
    if got.valid is not None:
        np.testing.assert_array_equal(np_of(got.valid), np_of(want.valid))


def _oracle_year(ms):
    return ms.astype("datetime64[ms]").astype("datetime64[Y]").astype(int) \
        + 1970


@pytest.fixture
def times_ms(rng):
    # 1890..2120, pre-epoch negatives and the edges around 1970 included
    edge = np.array([0, -1, 1, -1000, -999, -1001, 999, 86399999, 86400000,
                     -86400000, -86400001, 951782400000, -2203891200000])
    return np.concatenate([
        edge, rng.integers(-2_500_000_000_000, 4_700_000_000_000, 500)])


@pytest.mark.parametrize("field", FIELDS)
def test_extract_from_date64(field, times_ms):
    jc, tc = both(times_ms.astype(np.int64), GDFDtype.DATE64)
    assert_field_matches(field, jc, tc)
    if field == "year":
        np.testing.assert_array_equal(np_of(ops.extract_year(tc).data),
                                      _oracle_year(times_ms))


@pytest.mark.parametrize("unit", list(UNIT_SCALE), ids=lambda u: u.name)
@pytest.mark.parametrize("field", FIELDS)
def test_extract_from_timestamp_units_before_1970(unit, field, times_ms, rng):
    """Sub-second ticks must floor towards the earlier second, also for
    negative (pre-1970) values, in every unit."""
    scale = UNIT_SCALE[unit]
    ticks = (times_ms // 1000) * scale + rng.integers(0, scale,
                                                      times_ms.size)
    jc, tc = both(ticks.astype(np.int64), GDFDtype.TIMESTAMP, unit)
    assert_field_matches(field, jc, tc)


@pytest.mark.parametrize("field", FIELDS)
def test_extract_from_date32(field, times_ms):
    days = (times_ms // 86400000).astype(np.int32)
    jc, tc = both(days, GDFDtype.DATE32)
    assert_field_matches(field, jc, tc)


def test_extract_validity_passthrough(rng):
    ms = rng.integers(-10**12, 4 * 10**12, 50)
    jc, tc = both(ms.astype(np.int64), GDFDtype.DATE64,
                  null=rng.random(50) < 0.3)
    for field in FIELDS:
        assert_field_matches(field, jc, tc)


def test_extract_rejects_non_datetime():
    c = Column.from_array(np.arange(4, dtype=np.int64), device="cpu")
    with pytest.raises(GDFError):
        ops.extract_year(c)
