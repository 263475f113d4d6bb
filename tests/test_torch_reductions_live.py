"""Reductions over a table's live rows (`num_rows`) on the CPU: rows at or
past the device count enter as the op's identity, whatever they hold, the
count is never read on the host, and without a count the reductions are
the JAX package's."""
import functools

import jax
import numpy as np
import pytest
import torch

import libgdf_tpu
import libgdf_tpu.ops as jops
from libgdf_tpu_torch import Column, Table
from libgdf_tpu_torch import ops as tops
from libgdf_tpu_torch.core.errors import GDFError, GDFStatus
from libgdf_tpu_torch.core.table import _BLOCK, live_rows
from libgdf_tpu_torch.utils import tracing
from torch_parity import np_of

OPS = ("sum", "min", "max", "product", "sum_squared")
WRAPPERS = {"sum": tops.sum, "min": tops.min, "max": tops.max,
            "product": tops.product, "sum_squared": tops.sum_of_squares}
DTYPES = [np.int8, np.int32, np.int64, np.float32, np.float64]
N = 64
LIVE = [0, 1, 29, N]


def _dead_values(dtype) -> list:
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return [info.max, info.min]
    big = np.finfo(dtype).max
    return [np.nan, np.inf, -np.inf, big, -big]


def column(dtype, live: int, with_nulls: bool, seed: int = 3):
    """(values, null mask or None, Column): small live values (a product
    of them stays in range), the dead rows past `live` cycling through
    NaN, +-inf and the dtype's extremes."""
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        x = rng.integers(-2, 3, N).astype(dtype)
    else:
        x = (1 + 0.01 * rng.standard_normal(N)).astype(dtype)
    dead = _dead_values(dtype)
    for i in range(live, N):
        x[i] = dead[i % len(dead)]
    null = rng.random(N) < 0.25 if with_nulls else None
    return x, null, Column.from_masked(x, null, device="cpu")


def identity(op: str, dtype):
    if op in ("sum", "sum_squared"):
        return 0
    if op == "product":
        return 1
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return info.max if op == "min" else info.min
    return np.inf if op == "min" else -np.inf


def assert_same(got, want, dtype, op):
    got, want = np_of(got), np.asarray(want)
    assert got.dtype == want.dtype, (op, got.dtype, want.dtype)
    if np.issubdtype(dtype, np.integer) or op in ("min", "max"):
        np.testing.assert_array_equal(got, want, err_msg=op)
    else:
        rtol = 1e-5 if dtype == np.float32 else 1e-12
        np.testing.assert_allclose(got, want, rtol=rtol, err_msg=op)


@functools.lru_cache(maxsize=None)
def _jax_reductions():
    return jax.jit(lambda c: [jops.reduce(c, op) for op in OPS])


@pytest.mark.parametrize("with_nulls", [False, True])
@pytest.mark.parametrize("live", LIVE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_live_rows_equal_the_live_slice(dtype, live, with_nulls):
    """Each op over `live` rows of a column, its dead rows holding NaN,
    +-inf or extreme integers: libgdf_tpu's op over the first `live` rows
    alone (where none is live, the op's identity in its result dtype),
    through `reduce` and through each wrapper, with no host wait."""
    x, null, col = column(dtype, live, with_nulls)
    count = torch.tensor(live, dtype=torch.int32)
    if live == 0:
        wide = np.int64 if np.issubdtype(dtype, np.integer) else dtype
        wants = {op: np.asarray(identity(op, dtype),
                                dtype=dtype if op in ("min", "max") else wide)
                 for op in OPS}
    else:
        part = libgdf_tpu.Column.from_array(
            x[:live], valid=None if null is None else ~null[:live])
        wants = dict(zip(OPS, _jax_reductions()(part)))
    tracing.reset_counters()
    for op in OPS:
        got = tops.reduce(col, op, num_rows=count)
        assert got.dim() == 0
        assert_same(got, wants[op], dtype, op)
        assert_same(WRAPPERS[op](col, num_rows=count), wants[op], dtype, op)
    assert tracing.counters() == {"host_sync": 0, "reduce": 2 * len(OPS),
                                  "reduce.rows": 2 * len(OPS) * N}


@pytest.mark.parametrize("with_nulls", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_without_a_count_every_row_counts(dtype, with_nulls):
    """num_rows=None reads every row, the extremes of the tail included,
    as libgdf_tpu does, and as passing the capacity does."""
    x, null, col = column(dtype, 29, with_nulls)
    jc = libgdf_tpu.Column.from_array(x, valid=None if null is None
                                      else ~null)
    wants = _jax_reductions()(jc)
    for op, want in zip(OPS, wants):
        got = tops.reduce(col, op)
        assert_same(got, want, dtype, op)
        assert_same(tops.reduce(col, op, num_rows=None), want, dtype, op)
        full = tops.reduce(col, op, num_rows=torch.tensor(N))
        assert_same(full, np_of(got), dtype, op)


def test_a_filtered_tables_count_drops_its_dead_rows():
    """A filter's output keeps the input's capacity; summed with its own
    count, the dead rows (here refilled with a large value) are left
    out."""
    t = Table.from_dict({"v": np.arange(10, dtype=np.float64)},
                        device="cpu")
    f = tops.filter_table(t, tops.compare_scalar(t["v"], 3.5, "lt"))
    live = torch.arange(10) < f.num_rows
    dead = f["v"].with_data(torch.where(live, f["v"].data, 1e9))
    assert float(tops.sum(dead, num_rows=f.num_rows)) == 0 + 1 + 2 + 3
    assert float(tops.max(dead, num_rows=f.num_rows)) == 3
    assert float(tops.sum(dead)) > 1e9


@pytest.mark.parametrize("op", OPS)
def test_an_empty_column(op):
    """A column of no rows: with a count, the op's identity; without one,
    min and max raise, as before."""
    col = Column.from_masked(np.zeros(0, np.float64), None, device="cpu")
    got = tops.reduce(col, op, num_rows=torch.tensor(0, dtype=torch.int32))
    assert float(got) == identity(op, np.float64)
    if op in ("min", "max"):
        with pytest.raises(GDFError) as e:
            tops.reduce(col, op)
        assert e.value.status == GDFStatus.GDF_DATASET_EMPTY
    else:
        assert float(tops.reduce(col, op)) == identity(op, np.float64)


@pytest.mark.parametrize("n", [0, 1, _BLOCK - 1, _BLOCK, _BLOCK + 1,
                               3 * _BLOCK + 17])
def test_live_mask_at_block_edges(n):
    """The blocked live mask is `arange(n) < count` for every count, a
    0-d tensor or an int, at the edges of its blocks; every row without
    a count; and a table's `live_mask` is the same mask."""
    assert torch.equal(live_rows(n, None, "cpu"),
                       torch.ones(n, dtype=torch.bool))
    for k in sorted({0, 1, n // 2, max(n - 1, 0), n, _BLOCK} - {n + 1}):
        if k > n:
            continue
        for count in (k, torch.tensor(k, dtype=torch.int32)):
            got = live_rows(n, count, "cpu")
            assert got.shape == (n,) and got.is_contiguous()
            assert torch.equal(got, torch.arange(n) < k), (n, k)
        t = Table.from_dict({"v": np.zeros(n)}, device="cpu")
        assert torch.equal(t.with_num_rows(k).live_mask(),
                           torch.arange(n) < k), (n, k)
