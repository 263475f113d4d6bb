"""Float join and groupby keys that are denormal, against libgdf_tpu.

XLA flushes denormals in comparisons: the JAX package's `data == 0`
fix-up for float keys (libgdf_tpu/ops/join.py, ops/groupby.py) maps -0.0
and every float32 or float64 denormal to +0.0, so such keys match 0.0 in a
join and share its group. Float16 is no column dtype of either package
(XLA would widen it to float32 before comparing and not flush it). The
same numpy keys go through both packages on the CPU; join indices, counts,
groups and the groups' key bits must be equal.
"""
import numpy as np
import pytest

import libgdf_tpu.ops as jops
import libgdf_tpu_torch.ops as tops
from torch_parity import assert_tables_match, jax_op, make_tables, np_of

# dtype -> (a denormal, the smallest denormal)
DENORMALS = {np.float32: (1e-40, np.finfo(np.float32).smallest_subnormal),
             np.float64: (1e-310, np.finfo(np.float64).smallest_subnormal)}
UINT = {np.float32: np.uint32, np.float64: np.uint64}


def _keys(rng, dtype, n):
    d, s = DENORMALS[dtype]
    return rng.choice(np.array([d, -d, s, -s, 0.0, -0.0, 1.0], dtype), n)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_join_on_denormal_keys(rng, dtype, how):
    n, m = 60, 25
    left = {"k": _keys(rng, dtype, n), "a": np.arange(n, dtype=np.int32)}
    right = {"k": _keys(rng, dtype, m), "b": np.arange(m, dtype=np.int32)}
    jl, tl = make_tables(left, {"k": rng.random(n) < 0.1})
    jr, tr = make_tables(right, {"k": rng.random(m) < 0.1})
    ji, jj, jc = jops.join_indices(jl, jr, ["k"], ["k"], how=how)
    ti, tj, tc = tops.join_indices(tl, tr, ["k"], ["k"], how=how)
    assert int(tc) == int(jc)
    np.testing.assert_array_equal(np_of(ti), np_of(ji))
    np.testing.assert_array_equal(np_of(tj), np_of(jj))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dropna", [True, False])
def test_groupby_on_denormal_keys(rng, dtype, dropna):
    n = 80
    cols = {"k": _keys(rng, dtype, n),
            "v": rng.integers(0, 100, n).astype(np.int64)}
    jt, tt = make_tables(cols, {"k": rng.random(n) < 0.1,
                                "v": rng.random(n) < 0.1})
    aggs = (("v", "sum", "s"), ("v", "count", "c"))
    jg = jax_op("groupby", jt, key_names=("k",), aggs=aggs, dropna=dropna)
    tg = tops.groupby(tt, ["k"], aggs, dropna=dropna)
    assert int(tg.num_rows) == int(jg.num_rows)
    assert_tables_match(jg, tg, tie_keys=["k"], tie_break=["s", "c"])
    # the zero group's key is +0.0 in both, not a denormal or -0.0
    g = int(jg.num_rows)
    valid = np_of(jg["k"].valid)[:g]
    jk = np_of(jg["k"].data)[:g][valid]
    tk = np_of(tg["k"].data)[:g][valid]
    assert (jk == 0).sum() == 1
    np.testing.assert_array_equal(tk.view(UINT[dtype]), jk.view(UINT[dtype]))
