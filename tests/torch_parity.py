"""Helpers for the tests that hold libgdf_tpu_torch to libgdf_tpu.

Both packages get the same numpy columns; outputs come back to numpy over
the live rows and are compared column by column. Values are compared where
a row is valid (a NULL row's payload is unspecified in both packages).
"""
import functools

import jax
import numpy as np

import libgdf_tpu
from libgdf_tpu_torch.interop import from_numpy, to_numpy


def make_tables(columns, nulls=None, num_rows=None):
    """The same data as a libgdf_tpu Table and a libgdf_tpu_torch Table
    (CPU tensors); `num_rows` makes both capacity + count tables."""
    jt = libgdf_tpu.Table.from_dict(columns, nulls=nulls)
    tt = from_numpy(columns, nulls)
    if num_rows is not None:
        jt = jt.with_num_rows(num_rows)
        tt = tt.with_num_rows(num_rows)
    return jt, tt


@functools.lru_cache(maxsize=None)
def _jitted(name, static):
    fn = getattr(libgdf_tpu.ops, name)
    return jax.jit(lambda *args: fn(*args, **dict(static)))


def jax_op(name, *args, **static):
    """libgdf_tpu.ops.<name>(*args, **static) under jax.jit: one compile of
    the whole operator instead of one per eager primitive (the operators
    are written for jit). `static` values must be hashable."""
    return _jitted(name, tuple(sorted(static.items())))(*args)


def jax_to_numpy(table):
    t = table.compact()
    values, nulls = {}, {}
    for name, c in zip(t.names, t.columns):
        values[name], nulls[name] = c.to_numpy_masked()
    return values, nulls


def _order_ties(values, nulls, keys, tie_break):
    """Reorder rows inside each run of identical key columns (values and
    null flags) by the `tie_break` columns. A groupby with dropna=False
    makes every null-key row a group of its own; the JAX package sorts
    unstably, so the order among such rows with equal key data is
    unspecified there."""
    n = len(values[keys[0]])
    change = np.zeros(n, bool)
    change[:1] = True
    for k in keys:
        change[1:] |= ((values[k][1:] != values[k][:-1])
                       | (nulls[k][1:] != nulls[k][:-1]))
    block = np.cumsum(change)
    order = np.lexsort([np.where(nulls[c], 0, values[c])
                        for c in reversed(tie_break)] + [block])
    return ({c: v[order] for c, v in values.items()},
            {c: v[order] for c, v in nulls.items()})


def assert_tables_match(jax_table, torch_table, float_tol=None,
                        tie_keys=None, tie_break=()):
    """Names, row counts, null masks and integer values must match exactly;
    float columns to `float_tol` = {name: (rtol, atol)} (exact if absent).
    With `tie_keys`, rows with identical key columns are first ordered by
    the exact `tie_break` columns in both tables (see _order_ties)."""
    jv, jn = jax_to_numpy(jax_table)
    tv, tn = to_numpy(torch_table)
    assert list(jv) == list(tv)
    if tie_keys:
        for k in tie_keys:
            np.testing.assert_array_equal(tn[k], jn[k], err_msg=k)
            np.testing.assert_array_equal(tv[k], jv[k], err_msg=k)
        jv, jn = _order_ties(jv, jn, tie_keys, tie_break)
        tv, tn = _order_ties(tv, tn, tie_keys, tie_break)
    float_tol = float_tol or {}
    for name in jv:
        np.testing.assert_array_equal(tn[name], jn[name], err_msg=name)
        ok = ~jn[name]
        a, b = jv[name][ok], tv[name][ok]
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        if name in float_tol:
            rtol, atol = float_tol[name]
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def np_of(x):
    """numpy view of a JAX array or a torch tensor."""
    if hasattr(x, "cpu"):
        return x.cpu().numpy()
    return np.asarray(x)


__all__ = ["make_tables", "jax_op", "jax_to_numpy", "assert_tables_match",
           "np_of"]
