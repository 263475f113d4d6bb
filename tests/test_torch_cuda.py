"""Hopper kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc: it is marked `cuda` and
skips elsewhere. Run on a machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:xdist -q

Integers, counts, flags and row order must match exactly. Float sums are
held to a bound relative to the running sum of |x| (the kernel and the
plain version add in different orders): 2e-4 for float32, 1e-12 for
float64.
"""
import numpy as np
import pytest
import torch

from libgdf_tpu_torch.ops import kernels
from libgdf_tpu_torch.probes.caps import LOOP_ALL_ROWS_COLS

pytestmark = pytest.mark.cuda

# No element (an empty shard of the distributed path), the edges of H2's
# and H3's 32 KB tiles (8192 4-byte or 4096 8-byte elements), of H1's
# 4096-row tiles and of H4's 4096-slot runs, and many tiles plus one.
SIZES = [0, 1, 2047, 2048, 2049, 4095, 4096, 4097, 8191, 8192, 8193, 100_003,
         37 * 4096 + 1, 37 * 8192 + 1, 3_000_000]
DTYPES = [torch.int32, torch.int64, torch.float32, torch.float64]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    kernels.build()
    return torch.device("cuda")


def _values(rng, n, dtype, dev):
    if dtype.is_floating_point:
        x = rng.standard_normal(n)
    else:
        x = rng.integers(-1000, 1000, n)
    return torch.as_tensor(x, device=dev).to(dtype)


def _assert_scan_close(got, want, x, kind):
    if kind != "sum" or not x.dtype.is_floating_point:
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
        return
    rel = 2e-4 if x.dtype == torch.float32 else 1e-12
    bound = rel * torch.cumsum(x.abs().double(), 0) + rel
    assert bool(((got.double() - want.double()).abs() <= bound).all())


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["sum", "max", "min"])
def test_scan(dev, n, dtype, kind):
    rng = np.random.default_rng(n)
    x = _values(rng, n, dtype, dev)
    for reverse in (False, True):
        got = kernels.scan(kind, x, reverse=reverse)
        want = kernels.scan_plain(kind, x, reverse=reverse)
        if kind == "sum" and reverse:
            _assert_scan_close(got.flip(0), want.flip(0), x.flip(0), kind)
        else:
            _assert_scan_close(got, want, x, kind)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["sum", "max", "min", "carry"])
@pytest.mark.parametrize("density", [0.0, 0.01, 1.0])
def test_seg_scan(dev, n, dtype, kind, density):
    rng = np.random.default_rng(n + 7)
    x = _values(rng, n, dtype, dev)
    f = torch.as_tensor(rng.random(n) < density, device=dev)
    got = kernels.seg_scan(kind, f, x)
    want = kernels.seg_scan_plain(kind, f, x)
    if kind == "sum" and dtype.is_floating_point:
        rel = 2e-4 if dtype == torch.float32 else 1e-12
        absx = kernels.seg_scan_plain("sum", f, x.abs().double())
        assert bool(((got.double() - want.double()).abs()
                     <= rel * absx + rel).all())
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("n", [0, 1, 8193, 100_003])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16])
@pytest.mark.parametrize("kind", ["sum", "max", "min", "carry"])
def test_narrow_ints_run_as_int32(dev, n, dtype, kind):
    """int8 and int16 values (fault C10: the card raised TypeError) scan
    as int32 and come back narrowed, equal to the plain version over the
    dtype's whole range, where the sums wrap; the launch counts int32."""
    rng = np.random.default_rng(n + 11)
    info = torch.iinfo(dtype)
    x = torch.as_tensor(rng.integers(info.min, info.max, n, endpoint=True),
                        device=dev).to(dtype)
    f = torch.as_tensor(rng.random(n) < 0.01, device=dev)
    kernels.reset_launch_counts()
    got = [kernels.seg_scan(kind, f, x)]
    want = [kernels.seg_scan_plain(kind, f, x)]
    if kind != "carry":
        for reverse in (False, True):
            got.append(kernels.scan(kind, x, reverse=reverse))
            want.append(kernels.scan_plain(kind, x, reverse=reverse))
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    counts = kernels.launch_counts()
    assert counts.get(f"seg_scan[{dtype}]".replace("torch.", ""), 0) == 0
    if n:
        assert counts["seg_scan[int32]"] == 1


# H2's and H3's tiles hold 8192 4-byte or 4096 8-byte elements
FLUSH_SIZES = [0, 1, 4095, 4096, 4097, 8191, 8192, 8193, 37 * 8192 + 1,
               1_000_000]


def _flush_values(rng, n, dtype, dev, specials):
    """Zeros, +-denormals and +-1, 2 finfo.tiny (every flushed partial sum
    an exact multiple of finfo.tiny), denormals on both sides of every
    tile edge, and with `specials` NaN, inf and -inf near the end."""
    d = 1e-40 if dtype == torch.float32 else 1e-310
    t = torch.finfo(dtype).tiny
    x = rng.choice(np.array([0.0, -0.0, d, -d, 2 * d, t, -t, 2 * t, -2 * t]),
                   n)
    for edge in (4096, 8192):
        at = np.arange(edge, n + 1, edge)
        x[at[at < n]] = d
        x[at - 1] = -d
    if specials and n > 10:
        x[rng.integers(n - n // 10, n, 3)] = [np.nan, np.inf, -np.inf]
    return torch.as_tensor(x, device=dev).to(dtype)


@pytest.mark.parametrize("n", FLUSH_SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("specials", [False, True])
def test_scan_flush(dev, n, dtype, specials):
    """C7: H2's float sum, with the flush folded into its load, equals the
    plain version (flush, then scan) exactly, forward and reverse; the
    unflushed sum counts the denormals."""
    rng = np.random.default_rng(n + 11)
    x = _flush_values(rng, n, dtype, dev, specials)
    for reverse in (False, True):
        got = kernels.scan("sum", x, reverse=reverse)
        _same(got, kernels.scan_plain("sum", x, reverse))
        _same(got, kernels.scan("sum", x, reverse=reverse))
    if n >= 4096 and not specials:
        assert not torch.equal(torch.cumsum(x, 0), kernels.scan("sum", x))


@pytest.mark.parametrize("n", FLUSH_SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("density", [0.0, 0.01, 1.0])
def test_seg_scan_flush(dev, n, dtype, density):
    """C7: H3's float segmented sum equals the plain version (flush, then
    scan) exactly, NaN and inf included."""
    rng = np.random.default_rng(n + 13)
    x = _flush_values(rng, n, dtype, dev, True)
    f = torch.as_tensor(rng.random(n) < density, device=dev)
    _same(kernels.seg_scan("sum", f, x), kernels.seg_scan_plain("sum", f, x))


def test_flush_is_for_sums(dev):
    """Only a float sum flushes: max, min and carry keep denormals."""
    d = torch.tensor([1e-40, -1e-40, 2e-40, 0.0] * 3000, device=dev)
    f = torch.arange(d.shape[0], device=dev) % 7 == 0
    for kind in ("max", "min"):
        _same(kernels.scan(kind, d), kernels.scan_plain(kind, d))
        _same(kernels.seg_scan(kind, f, d), kernels.seg_scan_plain(kind, f, d))
    _same(kernels.seg_scan("carry", f, d), kernels.seg_scan_plain("carry", f, d))
    assert bool((kernels.scan("max", d) > 0).all())


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_scan_unaligned_view(dev, dtype, reverse):
    """A view that starts one element in takes the kernel's unaligned
    path."""
    x = _values(np.random.default_rng(9), 50_001, dtype, dev)[1:]
    for kind in ("sum", "max"):
        got = kernels.scan(kind, x, reverse=reverse)
        want = kernels.scan_plain(kind, x, reverse=reverse)
        if reverse:   # the running-sum bound in scan order
            _assert_scan_close(got.flip(0), want.flip(0), x.flip(0), kind)
        else:
            _assert_scan_close(got, want, x, kind)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_scan_look_back_is_exact_and_deterministic(dev, dtype):
    """All ones give out[i] == i + 1 exactly, forward and reverse; 50 int64
    sums of one input are bit-identical. A look-back that read a
    descriptor before it was published would break either."""
    n = 10_000_000
    ones = torch.ones(n, dtype=dtype, device=dev)
    want = torch.arange(1, n + 1, dtype=dtype, device=dev)
    assert torch.equal(kernels.scan("sum", ones), want)
    assert torch.equal(kernels.scan("sum", ones, reverse=True),
                       want.flip(0))
    x = _values(np.random.default_rng(4), n, dtype, dev) * 123_457
    first = kernels.scan("sum", x)
    assert torch.equal(first, kernels.scan_plain("sum", x))
    for _ in range(50):
        assert torch.equal(kernels.scan("sum", x), first)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_seg_scan_look_back_is_exact_and_deterministic(dev, dtype):
    """10M ones with no flag (the longest look-back) sum to exactly 1..n;
    with a flag every 100,003 rows they restart at each; 50 int64
    segmented sums of one input are bit-identical; all-flags `carry`
    returns its input."""
    n, every = 10_000_000, 100_003
    ones = torch.ones(n, dtype=dtype, device=dev)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    assert torch.equal(kernels.seg_scan("sum", none, ones),
                       (idx + 1).to(dtype))
    assert torch.equal(kernels.seg_scan("sum", idx % every == 0, ones),
                       (idx % every + 1).to(dtype))
    rng = np.random.default_rng(8)
    x = _values(rng, n, dtype, dev) * 123_457
    f = torch.as_tensor(rng.random(n) < 0.25, device=dev)
    first = kernels.seg_scan("sum", f, x)
    assert torch.equal(first, kernels.seg_scan_plain("sum", f, x))
    for _ in range(50):
        assert torch.equal(kernels.seg_scan("sum", f, x), first)
    assert torch.equal(kernels.seg_scan("carry", ~none, x), x)


@pytest.mark.parametrize("dtype", DTYPES)
def test_seg_scan_unaligned_views(dev, dtype):
    """Flags or values that start one element in take the scalar path."""
    rng = np.random.default_rng(10)
    n = 50_001
    x = _values(rng, n, dtype, dev)
    f = torch.as_tensor(rng.random(n) < 0.01, device=dev)
    for flags, vals in ((f[1:], x[1:]), (f[1:], x[:-1].clone()),
                        (f[:-1].clone(), x[1:])):
        for kind in ("max", "carry"):
            torch.testing.assert_close(
                kernels.seg_scan(kind, flags, vals),
                kernels.seg_scan_plain(kind, flags, vals), rtol=0, atol=0)


def test_scan_nan_propagates(dev):
    x = torch.tensor([1.0, float("nan"), 0.5, 3.0], device=dev)
    torch.testing.assert_close(kernels.scan("max", x),
                               kernels.scan_plain("max", x), equal_nan=True)
    f = torch.tensor([True, False, True, False], device=dev)
    torch.testing.assert_close(kernels.seg_scan("min", f, x),
                               kernels.seg_scan_plain("min", f, x),
                               equal_nan=True)


@pytest.mark.parametrize("n", SIZES + [10_000_000])
@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_compact(dev, n, p):
    rng = np.random.default_rng(n + 11)
    keep = torch.as_tensor(rng.random(n) < p, device=dev)
    arrays = [
        torch.as_tensor(rng.integers(-2**62, 2**62, n), device=dev),
        torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=dev),
        torch.as_tensor(rng.standard_normal(n), device=dev),
        torch.as_tensor(rng.integers(-100, 100, n).astype(np.int16),
                        device=dev),
        torch.as_tensor(rng.random(n) < 0.5, device=dev),
        torch.as_tensor(rng.integers(0, 255, n).astype(np.uint8), device=dev),
    ]
    got, cnt = kernels.compact(arrays, keep)
    want, wcnt = kernels.compact_plain(arrays, keep)
    c = int(wcnt)
    assert int(cnt) == c
    for g, w in zip(got, want):
        torch.testing.assert_close(g[:c], w[:c], rtol=0, atol=0)


def test_compact_look_back_is_exact_and_deterministic(dev):
    """Over 10M rows: all kept gives the arange payload and count n; every
    other row gives arange[::2]; none kept gives count 0; 50 compactions of
    one input are bit-identical. A look-back that read a tile count before
    it was published would break them."""
    n = 10_000_000
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    for keep, want in ((idx >= 0, idx), (idx % 2 == 0, idx[::2]),
                       (idx < 0, idx[:0])):
        (got,), cnt = kernels.compact([idx], keep)
        assert int(cnt) == want.shape[0]
        assert torch.equal(got[:want.shape[0]], want)
    rng = np.random.default_rng(6)
    keep = torch.as_tensor(rng.random(n) < 0.45, device=dev)
    arrays = [idx * 7, torch.as_tensor(rng.random(n) < 0.5, device=dev)]
    first, c0 = kernels.compact(arrays, keep)
    c = int(c0)
    for _ in range(50):
        again, cnt = kernels.compact(arrays, keep)
        assert int(cnt) == c
        for g, w in zip(again, first):
            assert torch.equal(g[:c], w[:c])


def test_compact_unaligned_views(dev):
    """keep or the arrays one element in take the scalar paths."""
    rng = np.random.default_rng(12)
    n = 50_001
    keep = torch.as_tensor(rng.random(n) < 0.3, device=dev)
    a8 = torch.as_tensor(rng.integers(-2**62, 2**62, n), device=dev)
    a1 = torch.as_tensor(rng.random(n) < 0.5, device=dev)
    for kp, arrays in ((keep[1:], [a8[1:], a1[1:]]),
                       (keep[1:], [a8[:-1].clone(), a1[:-1].clone()]),
                       (keep[:-1].clone(), [a8[1:], a1[1:]])):
        got, cnt = kernels.compact(arrays, kp)
        want, wcnt = kernels.compact_plain(arrays, kp)
        c = int(wcnt)
        assert int(cnt) == c
        for g, w in zip(got, want):
            assert torch.equal(g[:c], w[:c])


def test_compact_many_arrays(dev):
    """More arrays than one launch takes: the wrapper splits them."""
    rng = np.random.default_rng(3)
    n = 50_000
    keep = torch.as_tensor(rng.random(n) < 0.4, device=dev)
    arrays = [torch.as_tensor(rng.integers(0, 1 << 30, n).astype(np.int32),
                              device=dev) for _ in range(37)]
    got, cnt = kernels.compact(arrays, keep)
    want, wcnt = kernels.compact_plain(arrays, keep)
    c = int(wcnt)
    assert int(cnt) == c
    for g, w in zip(got, want):
        torch.testing.assert_close(g[:c], w[:c], rtol=0, atol=0)


def _expand_case(dev, rng, cap, pos):
    pos = np.concatenate([pos, np.full(5, kernels.SENTINEL)]).astype(np.int32)
    words = [torch.as_tensor(rng.integers(-2**30, 2**30, pos.size)
                             .astype(np.int32), device=dev),
             torch.as_tensor(rng.integers(-2**62, 2**62, pos.size),
                             device=dev)]
    pos_t = torch.as_tensor(pos, device=dev)
    got = kernels.expand_fill(pos_t, words, cap)
    want = kernels.expand_fill_plain(pos_t, words, cap)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("cap,density", [
    (1, 1.0), (2048, 0.5), (4095, 0.3), (4096, 1.0), (4097, 0.5),
    (37 * 4096 + 1, 0.2), (100_003, 0.1), (3_000_000, 0.9),
    (40_000_000, 0.25)])
def test_expand_fill(dev, cap, density):
    rng = np.random.default_rng(cap)
    nsrc = max(1, int(cap * density))
    _expand_case(dev, rng, cap,
                 np.sort(rng.choice(cap, nsrc, replace=False)))


@pytest.mark.parametrize("cap,first,gap", [
    (100_003, 0, 5_000), (100_003, 9_000, 4_096), (1_000_000, 70_001, 9_999),
    (50_000, 40_000, 3)])
def test_expand_fill_sparse(dev, cap, first, gap):
    """Gaps between sources longer than one 4096-slot run (runs that no
    source starts in), and a first source after slot 0."""
    rng = np.random.default_rng(cap + first)
    pos = first + np.cumsum(rng.integers(1, 2 * gap, cap // gap + 1))
    _expand_case(dev, rng, cap, pos[pos < cap])


def test_expand_fill_no_sources(dev):
    pos = torch.full((3,), kernels.SENTINEL, dtype=torch.int32, device=dev)
    w = torch.arange(3, dtype=torch.int32, device=dev)
    (got,) = kernels.expand_fill(pos, [w], 1000)
    assert int(got.abs().sum()) == 0


@pytest.mark.parametrize("cap", [0, 1000])
def test_expand_fill_of_zero_sources(dev, cap):
    pos = torch.zeros(0, dtype=torch.int32, device=dev)
    words = [torch.zeros(0, dtype=dt, device=dev)
             for dt in (torch.int32, torch.int64)]
    got = kernels.expand_fill(pos, words, cap)
    for g, w in zip(got, kernels.expand_fill_plain(pos, words, cap)):
        assert g.shape == (cap,)
        torch.testing.assert_close(g, w.to(dev), rtol=0, atol=0)


def test_wrappers_refuse_what_they_cannot_launch(dev):
    # int8 / int16 launch as int32 since C10; no column is float16
    x = torch.arange(10, dtype=torch.float16, device=dev)
    with pytest.raises(TypeError):
        kernels.scan("sum", x)
    y = torch.arange(20, dtype=torch.int32, device=dev)[::2]
    with pytest.raises(ValueError):
        kernels.scan("sum", y)
    with pytest.raises(ValueError):
        kernels.compact([torch.zeros(10, dtype=torch.int32)],
                        torch.ones(10, dtype=torch.bool, device=dev))


def test_pipeline_gpu_matches_cpu(dev):
    """The slice on CUDA tensors against the same code on CPU tensors."""
    from libgdf_tpu_torch import Table, ops
    rng = np.random.default_rng(5)
    n, nk = 200_000, 20_000
    cols = {"k": rng.integers(0, nk, n).astype(np.int64),
            "v": rng.standard_normal(n).astype(np.float32)}
    nulls = {"k": rng.random(n) < 0.05, "v": rng.random(n) < 0.1}
    dim = {"k": np.repeat(rng.permutation(nk), 3).astype(np.int64),
           "w": rng.standard_normal(3 * nk).astype(np.float32)}
    outs = {}
    for d in ("cpu", "cuda"):
        fact = Table.from_dict(cols, nulls, device=d)
        dt = Table.from_dict(dim, device=d)
        filt = ops.filter_table(fact, ops.compare_scalar(fact["v"], 0.0,
                                                         "lt"))
        li, ri, c = ops.inner_join(filt, dt, ["k"], ["k"])
        outs[d] = (int(filt.num_rows), li.cpu(), ri.cpu(), int(c))
    assert outs["cpu"][0] == outs["cuda"][0]
    assert outs["cpu"][3] == outs["cuda"][3]
    torch.testing.assert_close(outs["cpu"][1], outs["cuda"][1], rtol=0,
                               atol=0)
    torch.testing.assert_close(outs["cpu"][2], outs["cuda"][2], rtol=0,
                               atol=0)


def _analytic_table(n, device, seed):
    from libgdf_tpu_torch import Table
    rng = np.random.default_rng(seed)
    cols = {"p": rng.integers(0, 7, n).astype(np.int32),
            "o": rng.integers(0, max(n // 3, 1), n).astype(np.int32),
            "v": rng.standard_normal(n).astype(np.float32),
            "q": rng.integers(-2**62, 2**62, n),
            "x": rng.standard_normal(n) * np.exp(rng.uniform(-9, 9, n))}
    return Table.from_dict(cols, {"v": rng.random(n) < 0.1}, device=device)


@pytest.mark.parametrize("n", [1, 2049, 100_003])
@pytest.mark.parametrize("red", ["sum", "min", "max", "count", "avg", "var"])
@pytest.mark.parametrize("frame,preceding", [("rows", 300), ("rows", None),
                                             ("range", 50)])
def test_window_gpu_matches_cpu(dev, n, red, frame, preceding):
    """min, max, count and validity exact; the sum family within 2e-12 of
    the total sum of |v| (or of v^2 for var): its float64 prefix sums run
    over the whole sorted column, in another order on the card."""
    from libgdf_tpu_torch import ops
    outs = {}
    for d in ("cpu", "cuda"):
        t = _analytic_table(n, d, n)
        outs[d] = ops.window_function(t, "v", red, preceding=preceding,
                                      partition_by=["p"], order_by=["o"],
                                      frame=frame)
    g, c = outs["cuda"], outs["cpu"]
    torch.testing.assert_close(g.valid.cpu(), c.valid, rtol=0, atol=0)
    gd = torch.where(c.valid, g.data.cpu(), 0.0)
    cd = torch.where(c.valid, c.data, 0.0)
    if red in ("min", "max", "count"):
        torch.testing.assert_close(gd, cd, rtol=0, atol=0)
        return
    v = _analytic_table(n, "cpu", n)["v"].data.double()
    scale = (v * v).sum() if red == "var" else v.abs().sum()
    assert bool(((gd - cd).abs() <= 2e-12 * scale + 1e-12).all())


@pytest.mark.parametrize("n", [1, 2047, 2048, 100_003, 3_000_000])
def test_prefixsum_gpu_matches_cpu(dev, n):
    """int64 exact (H2 at int64 wraps as the plain version does); float64
    within 1e-12 of the running sum of |x|."""
    from libgdf_tpu_torch import ops
    t, c = _analytic_table(n, "cuda", n), _analytic_table(n, "cpu", n)
    for inclusive in (True, False):
        torch.testing.assert_close(ops.prefixsum(t["q"], inclusive).data.cpu(),
                                   ops.prefixsum(c["q"], inclusive).data,
                                   rtol=0, atol=0)
    got = ops.prefixsum(t["x"]).data.cpu()
    want = ops.prefixsum(c["x"]).data
    bound = 1e-12 * torch.cumsum(c["x"].data.abs(), 0) + 1e-12
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("n", [1, 2049, 100_003])
def test_quantiles_and_reductions_gpu_match_cpu(dev, n):
    from libgdf_tpu_torch import ops
    t, c = _analytic_table(n, "cuda", n), _analytic_table(n, "cpu", n)
    for m in ("linear", "lower", "higher", "midpoint", "nearest"):
        for q in (0.0, 0.5, 0.9, 1.0):
            assert float(ops.quantile_exact(t["v"], q, m)) == \
                float(ops.quantile_exact(c["v"], q, m))
    assert float(ops.quantile_approx(t["v"], 0.3)) == \
        float(ops.quantile_approx(c["v"], 0.3))
    for op in ("min", "max"):
        assert float(ops.reduce(t["v"], op)) == float(ops.reduce(c["v"], op))
    assert int(ops.reduce(t["q"], "sum")) == int(ops.reduce(c["q"], "sum"))
    torch.testing.assert_close(ops.reduce(t["v"], "sum").cpu(),
                               ops.reduce(c["v"], "sum"), rtol=1e-5,
                               atol=1e-5 * float(c["v"].data.abs().sum()))


@pytest.mark.parametrize("live", [0, 1, 2049, 100_003])
def test_reductions_over_live_rows_gpu_match_cpu(dev, live):
    """A device count: the dead rows past it (NaN, +-inf, 1e300) leave
    every op as on the CPU, and no host wait is counted."""
    from libgdf_tpu_torch import Column, ops
    from libgdf_tpu_torch.utils import tracing
    n = 100_003
    x = torch.as_tensor(np.random.default_rng(live).standard_normal(n))
    x[live:] = torch.tensor([np.nan, np.inf, -np.inf, 1e300]).repeat(
        n)[:n - live]
    cols = {d: Column.from_array(x.to(d)) for d in ("cuda", "cpu")}
    counts = {d: torch.tensor(live, dtype=torch.int32, device=d)
              for d in ("cuda", "cpu")}
    tracing.reset_counters()
    got = {op: ops.reduce(cols["cuda"], op, num_rows=counts["cuda"])
           for op in ("sum", "min", "max", "sum_squared")}
    assert tracing.counters()["host_sync"] == 0
    for op, g in got.items():
        want = ops.reduce(cols["cpu"], op, num_rows=counts["cpu"])
        assert g.device.type == "cuda"
        if op in ("min", "max"):
            assert float(g) == float(want)
        else:
            torch.testing.assert_close(g.cpu(), want, rtol=1e-12,
                                       atol=1e-12 * n)


# -- the flat gdf_* ABI on the card, against the same calls on CPU tensors ---

def _abi_same(g, c, rtol=None):
    """A Column from the card against the CPU's: dtype, validity and the
    valid rows' values (exact, or to rtol)."""
    assert g.device.type == "cuda" and c.device.type == "cpu"
    assert g.info == c.info and g.size == c.size
    assert (g.valid is None) == (c.valid is None)
    gd, cd = g.data.cpu(), c.data
    if c.valid is not None:
        torch.testing.assert_close(g.valid.cpu(), c.valid, rtol=0, atol=0)
        gd, cd = gd[c.valid], cd[c.valid]
    torch.testing.assert_close(gd, cd, rtol=rtol or 0, atol=0,
                               equal_nan=True)


def _views(gdf, data, null=None):
    valid = None if null is None else ~null
    return (gdf.gdf_column_view(data, valid),
            gdf.gdf_column_view(data, valid, device="cpu"))


def test_abi_pipeline_on_the_card(dev):
    """view -> compare -> stencil -> join -> group_by -> order_by ->
    radixsort -> prefixsum -> csr: numpy goes to the card by default, and
    every result equals the CPU run's."""
    from libgdf_tpu_torch.compat import gdf
    rng = np.random.default_rng(5)
    n, m = 300_000, 20_000
    key = rng.integers(0, m, n)
    knull = rng.random(n) < 0.05
    res = []
    for device in (None, "cpu"):
        def mk(d, v=None, name=""):
            return gdf.gdf_column_view(
                d, None if v is None else ~v, device=device).with_name(name)
        k = mk(key, knull, "k")
        a = mk(np.random.default_rng(6).integers(-999, 999, n)
               .astype(np.int32), None, "a")
        x = mk(np.random.default_rng(7).standard_normal(n),
               np.random.default_rng(8).random(n) < 0.1, "x")
        q = mk(np.random.default_rng(9).integers(-2**40, 2**40, n), None,
               "q")
        st = gdf.gpu_comparison_static_i64(k, m // 2, "lt")
        kept = [gdf.gpu_apply_stencil(col, st) for col in (k, a, x, q)]
        dk = mk(np.random.default_rng(3).permutation(m), None, "k")
        dw = mk(np.random.default_rng(4).integers(0, 9, m), None, "w")
        joined = gdf.gdf_inner_join(kept, 4, [0], [dk, dw], 2, [0], 1)
        by = {col.name: col for col in joined}
        keys, tot = gdf.gdf_group_by_sum(1, [by["k"]], by["x"])
        _, tot_i = gdf.gdf_group_by_sum(1, [by["k"]], by["q"])
        _, top = gdf.gdf_group_by_max(1, [by["k"]], by["q"])
        order = gdf.gdf_order_by([by["w"], by["k"]], 2)
        plan = gdf.gdf_radixsort_plan(joined[0].size, True, 8, 24)
        gdf.gdf_radixsort_plan_setup(plan)
        sk, sv = gdf.gdf_radixsort_i32(plan, by["a"], by["q"])
        ps = gdf.gdf_prefixsum_i64(by["q"].with_valid(None))
        csr = gdf.gdf_to_csr([by["x"], by["x"]])
        res.append((kept + joined + keys + [tot_i, top, order, sk, sv, ps],
                    tot, csr))
    (gcols, gtot, gcsr), (ccols, ctot, ccsr) = res
    for g, c in zip(gcols, ccols):
        _abi_same(g, c)
    _abi_same(gtot, ctot, rtol=1e-11)
    assert int(gcsr.nnz) == int(ccsr.nnz)
    for f in ("A", "IA", "JA"):
        torch.testing.assert_close(getattr(gcsr, f).cpu(), getattr(ccsr, f),
                                   rtol=0, atol=0)
    # the join's build keys are unique, so it needs no expand_fill
    counts = kernels.launch_counts()
    for name in ("compact", "scan[int32]", "scan[int64]", "seg_scan[int64]",
                 "seg_scan[float64]"):
        assert counts.get(name, 0) > 0, name


@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.int64])
def test_integer_floordiv_by_zero_on_the_card(dev, dtype):
    from libgdf_tpu_torch.compat import gdf
    lo, hi = np.iinfo(dtype).min, np.iinfo(dtype).max
    a = np.array([5, -5, 0, lo, hi, lo, hi, 7, -7, lo, 1], dtype)
    b = np.array([0, 0, 0, 0, 0, -1, -1, 2, 2, 1, -1], dtype)
    (ga, ca), (gb, cb) = _views(gdf, a), _views(gdf, b)
    got = gdf.gdf_floordiv_generic(ga, gb)
    _abi_same(got, gdf.gdf_floordiv_generic(ca, cb))
    assert got.data[:3].tolist() == [-2, -2, -1]


def test_float_division_edge_cases_on_the_card(dev):
    from libgdf_tpu_torch.compat import gdf
    a = np.array([5., -5., 0., 7.5, -7.5, np.inf, 1., np.nan, 6.])
    b = np.array([0., 0., 0., 2., 2., 3., np.inf, 1., -0.])
    (ga, ca), (gb, cb) = _views(gdf, a), _views(gdf, b)
    got = gdf.gdf_floordiv_f64(ga, gb)
    _abi_same(got, gdf.gdf_floordiv_f64(ca, cb))
    assert torch.isnan(got.data[:2]).all()
    (gi, ci), (gj, cj) = _views(gdf, np.arange(-3, 4)), \
        _views(gdf, np.array([2, 0, 3, 0, 5, 0, 7]))
    got = gdf.gdf_div_generic(gi, gj)
    assert got.data.dtype == torch.float64
    _abi_same(got, gdf.gdf_div_generic(ci, cj))


@pytest.mark.parametrize("src", [np.float32, np.float64])
def test_float_to_integer_casts_saturate_on_the_card(dev, src):
    from libgdf_tpu_torch.compat import gdf
    x = np.array([np.nan, np.inf, -np.inf, 3e10, -3e10, 300.7, -300.7,
                  127.5, 128.0, -128.5, -129.0, 2147483520.0, 2147483648.0,
                  -2147483904.0, 9.2e18, 9.3e18, -9.3e18, 1e38, 0.5, -0.0],
                 src)
    gx, cx = _views(gdf, x)
    sfx = "f32" if src == np.float32 else "f64"
    for to in ("i8", "i32", "i64", "date32", "timestamp"):
        fn = getattr(gdf, f"gdf_cast_{sfx}_to_{to}")
        _abi_same(fn(gx), fn(cx))
    got = getattr(gdf, f"gdf_cast_{sfx}_to_i32")(gx).data[:5].tolist()
    assert got == [0, 2147483647, -2147483648, 2147483647, -2147483648]


def test_read_csv_lands_on_the_card(dev, tmp_path):
    from libgdf_tpu_torch.compat import gdf
    from libgdf_tpu_torch.io import CSVReadArg
    p = tmp_path / "t.csv"
    p.write_text("0,0.0,10,a\n1,1.5,,b\n2,-2.25,30,\n3,,40,a\n,4.75,50,c\n")
    kw = dict(file_path=str(p), names=["a", "b", "c", "s"],
              dtype=["int32", "float64", "int64", "str"])
    arg = CSVReadArg(**kw)
    t = gdf.read_csv(arg)
    c = gdf.read_csv(CSVReadArg(**kw), device="cpu")
    assert t.device.type == "cuda" and arg.scanner in ("native", "python")
    for g, w in zip(t.columns, c.columns):
        _abi_same(g, w)
    assert t.categories == c.categories == {"s": ["a", "b", "c"]}


def test_nvtx_range_seen_in_a_profile(dev):
    from torch.profiler import ProfilerActivity, profile
    from libgdf_tpu_torch.compat import gdf
    a = gdf.gdf_column_view(np.arange(1000))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gdf.gdf_nvtx_range_push("LIBGDF_TEST_RANGE", "green")
        gdf.gdf_add_i64(a, a)
        torch.cuda.synchronize()
        gdf.gdf_nvtx_range_pop()
    gdf.gdf_nvtx_range_pop()
    assert any(e.key == "LIBGDF_TEST_RANGE" for e in prof.key_averages())


def test_rmm_on_the_card(dev):
    from libgdf_tpu_torch import memory as rmm
    rmm.rmmInitialize()
    try:
        h = rmm.rmmAlloc(8, dtype=np.int32)
        assert rmm.rmmGetArray(h).is_cuda
        rmm.rmmGetArray(h).copy_(torch.arange(8, dtype=torch.int32))
        rmm.rmmRealloc(h, 16)
        assert rmm.rmmGetArray(h).is_cuda
        assert rmm.rmmGetArray(h).tolist() == list(range(8)) + [0] * 8
        arr = rmm.to_device(np.arange(10))
        assert arr.is_cuda and arr.tolist() == list(range(10))
        rmm.rmmFree(h)
        free, total = rmm.rmmGetInfo()
        assert (free, total)[1] == torch.cuda.mem_get_info()[1] and free > 0
        lines = rmm.rmmGetLog().strip().splitlines()
        assert [ln.split(",")[0] for ln in lines[1:]] == \
            ["Alloc", "Realloc", "Alloc", "Free"]
        assert all(int(ln.split(",")[6]) == total for ln in lines[1:])
    finally:
        rmm.rmmFinalize()


@pytest.mark.parametrize("p", [0.0, 0.4, 1.0])
def test_compaction_indices_on_the_card(dev, p):
    from libgdf_tpu_torch.ops.compaction import compaction_indices
    rng = np.random.default_rng(11)
    keep = rng.random(1_000_003) < p
    perm, count = compaction_indices(torch.as_tensor(keep, device=dev))
    assert int(count) == int(keep.sum())
    want = np.concatenate([np.flatnonzero(keep), np.flatnonzero(~keep)])
    assert np.array_equal(perm.cpu().numpy(), want)


def _dist_inputs(device):
    from libgdf_tpu_torch import Table
    rng = np.random.default_rng(17)
    n = 4000
    fact = Table.from_dict(
        {"k": (rng.zipf(1.3, n) % 500).astype(np.int64),
         "v": rng.standard_normal(n).astype(np.float32)},
        {"v": rng.random(n) < 0.1}, device=device)
    dim = Table.from_dict({"k": np.arange(500, dtype=np.int64),
                           "w": rng.random(500).astype(np.float32)},
                          device=device)
    return fact, dim


@pytest.mark.parametrize("op", ["dist_groupby", "dist_join"])
def test_distributed_on_the_card_matches_cpu(dev, op):
    """P = 8 in-process shards on the card against the same pipeline on
    8 CPU shards: per-shard counts and live rows exact, float32 sums to
    rtol 1e-5, atol 1e-5 (the segmented scans add in another order)."""
    from libgdf_tpu_torch import parallel as par
    res = {}
    for d in ("cpu", "cuda"):
        mesh = par.make_mesh(8, device=d)
        fact, dim = (par.distribute(t, mesh) for t in _dist_inputs(d))
        if op == "dist_groupby":
            out = par.dist_groupby(mesh, fact, ["k"], [
                ("v", "sum", "s"), ("v", "count", "c"), ("v", "avg", "a")],
                num_batches=2)
        else:
            out = par.dist_join(mesh, fact, dim, ["k"], ["k"], how="left",
                                out_capacity_per_shard=4000)
        res[d] = out
    g, c = res["cuda"], res["cpu"]
    assert g.capacity == c.capacity
    assert g.counts.cpu().tolist() == c.counts.tolist()
    for gs, cs, k in zip(g.shards, c.shards, c.counts.tolist()):
        for name in cs.names:
            gc, cc = gs[name], cs[name]
            assert (gc.valid is None) == (cc.valid is None)
            ok = torch.ones(k, dtype=torch.bool) if cc.valid is None \
                else cc.valid[:k]
            if gc.valid is not None:
                assert torch.equal(gc.valid[:k].cpu(), ok)
            gv, cv = gc.data[:k].cpu()[ok], cc.data[:k][ok]
            if name in ("s", "a"):
                torch.testing.assert_close(gv, cv, rtol=1e-5, atol=1e-5)
            else:
                assert torch.equal(gv, cv), name


def _quarter_pipeline(mesh, n, skew=1, seed=23):
    """filter -> shuffle join -> broadcast join -> groupby (sum, count) on
    `mesh`, over float32 values that are multiples of 1/4 (every sum of
    them is exact in any order, so any difference is a lost, doubled or
    stale row). With skew > 1, shard 0 holds skew x the live rows of each
    other shard. Returns the ShardedTables (join, broadcast, groupby)."""
    from dataclasses import replace

    from libgdf_tpu_torch import Table, ops
    from libgdf_tpu_torch import parallel as par
    P = mesh.size
    per = -(-n // (P - 1 + skew))
    cap = per * skew
    rng = np.random.default_rng(seed)
    fact = Table.from_dict(
        {"k": (rng.zipf(1.3, P * cap) % 500).astype(np.int64),
         "v": (np.round(rng.standard_normal(P * cap) * 4) / 4)
         .astype(np.float32)},
        {"v": rng.random(P * cap) < 0.1}, device=mesh.device)
    dim = Table.from_dict({"k": np.arange(500, dtype=np.int64),
                           "w": rng.random(500).astype(np.float32)},
                          device=mesh.device)
    sf = par.distribute(fact, mesh)
    sf = replace(sf, counts=torch.tensor([cap] + [per] * (P - 1),
                                         dtype=torch.int32,
                                         device=mesh.device))
    sd = par.distribute(dim, mesh)
    f = par.map_shards(mesh, lambda t: ops.filter_table(
        t, ops.compare_scalar(t["v"], -1.0, "gt")), sf)
    # room for every fact row on one shard: the Zipf keys' hot rows meet
    j = par.dist_join(mesh, f, sd, ["k"], ["k"], num_batches=2,
                      out_capacity_per_shard=P * cap)
    b = par.broadcast_join(mesh, f, sd, ["k"], ["k"])
    g = par.dist_groupby(mesh, j, ["k"], [("v", "sum", "s"),
                                          ("v", "count", "c")],
                         num_batches=2)
    return j, b, g


def _same_shards(got, want, what):
    """Capacity, per-shard counts, and each shard's live rows: null masks
    and data bit for bit."""
    assert got.capacity == want.capacity, what
    counts = want.counts.cpu().tolist()
    assert got.counts.cpu().tolist() == counts, what
    for s, (gs, ws, k) in enumerate(zip(got.shards, want.shards, counts)):
        for name in ws.names:
            gc, wc = gs[name], ws[name]
            g_ok = gc.valid_or_true()[:k].cpu()
            w_ok = wc.valid_or_true()[:k].cpu()
            assert torch.equal(g_ok, w_ok), (what, s, name)
            assert torch.equal(gc.data[:k].cpu()[w_ok],
                               wc.data[:k].cpu()[w_ok]), (what, s, name)


def _one_stream(mesh):
    """Every shard on the caller's current stream of its card: the
    in-process mesh without a stream per shard."""
    return [torch.cuda.current_stream(d) for d in mesh.devices]


def test_per_shard_streams_match_one_stream(dev, monkeypatch):
    """P = 8 shards on one card, each on its own stream, 20 times: keys,
    counts and sums bit-identical to the same pipeline with every shard on
    one stream, and to 8 shards on the CPU."""
    from libgdf_tpu_torch import parallel as par
    from libgdf_tpu_torch.parallel.mesh import Mesh
    mesh = par.make_mesh(8, device=dev)
    streams = mesh.shard_streams()
    assert len({s.cuda_stream for s in streams}) == 8
    with monkeypatch.context() as m:
        m.setattr(Mesh, "shard_streams", _one_stream)
        want = _quarter_pipeline(par.make_mesh(8, device=dev), 200_000)
    cpu = _quarter_pipeline(par.make_mesh(8, device="cpu"), 200_000)
    for w, c, what in zip(want, cpu, ("join", "broadcast", "groupby")):
        _same_shards(w, c, f"one stream vs cpu {what}")
    for i in range(20):
        got = _quarter_pipeline(mesh, 200_000)
        for g, w, what in zip(got, want, ("join", "broadcast", "groupby")):
            _same_shards(g, w, f"repeat {i} {what}")


def test_forced_skew_peers_read_a_busy_producer(dev):
    """Shard 0 holds 50x the rows of each other shard, so its kernels are
    still running when its peers read what it sent: 5 runs equal the CPU
    run shard by shard, bit for bit."""
    from libgdf_tpu_torch import parallel as par
    mesh = par.make_mesh(8, device=dev)
    want = _quarter_pipeline(par.make_mesh(8, device="cpu"), 600_000,
                             skew=50)
    for i in range(5):
        got = _quarter_pipeline(mesh, 600_000, skew=50)
        for g, w, what in zip(got, want, ("join", "broadcast", "groupby")):
            _same_shards(g, w, f"skewed run {i} {what}")


@pytest.mark.parametrize("per_card", [1, 2])
def test_one_shard_per_card(dev, per_card):
    """make_mesh(C) on a node of C >= 2 cards: shard s on cuda:s (and with
    2C shards, shard s on cuda:(s % C)), the pipeline equal to the CPU run
    of as many shards, shard by shard; collect() on cuda:0."""
    from libgdf_tpu_torch import parallel as par
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip(f"one shard per card needs 2 cards or more; this "
                    f"machine has {cards}")
    P = cards * per_card
    mesh = par.make_mesh(None if per_card == 1 else P)
    assert mesh.devices == tuple(torch.device("cuda", s % cards)
                                 for s in range(P))
    got = _quarter_pipeline(mesh, 300_000)
    want = _quarter_pipeline(par.make_mesh(P, device="cpu"), 300_000)
    for g, w, what in zip(got, want, ("join", "broadcast", "groupby")):
        _same_shards(g, w, what)
        assert [s.device for s in g.shards] == list(mesh.devices)
        assert g.counts.device == torch.device("cuda", 0)
        assert par.collect(g).device == torch.device("cuda", 0)


def test_every_dtype_crosses_nccl(dev, tmp_path):
    """Every collective over every column dtype of core/dtypes.py and bool
    (tests/test_torch_process_mesh.py::collectives), through a one-rank
    cpu:gloo,cuda:nccl group with 4 shards on the card: the same bytes on
    every rank as the in-process mesh of 4 shards on the card. NCCL has no
    int16 either (fault C9): it crosses as its bytes."""
    import torch.distributed as dist
    from libgdf_tpu_torch import parallel as par
    from libgdf_tpu_torch.parallel.distributed import _spmd
    from libgdf_tpu_torch.parallel.mesh import Mesh
    from test_torch_process_mesh import LOCAL, collectives, same_bytes
    card = torch.device("cuda", torch.cuda.current_device())
    threads = Mesh(LOCAL, card, "threads", tuple(range(LOCAL)))
    want = _spmd(threads, par.DEFAULT_AXIS, collectives)
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = par.make_mesh(LOCAL, device=card)
        assert mesh.backend == "process_group"
        got = _spmd(mesh, par.DEFAULT_AXIS, collectives)
    finally:
        dist.destroy_process_group()
    for g, w in zip(got, want):
        same_bytes(g, w)


@pytest.mark.parametrize("layout", ["one process of 8", "2 processes"])
def test_processes_equal_the_in_process_mesh(dev, layout, tmp_path):
    """A mesh across processes over NCCL (tests/torch_mp_worker.py,
    --device cuda): one process of 8 shards on cuda:0 in a one-rank
    cpu:gloo,cuda:nccl group, and on a node of C >= 2 cards 2 processes of
    C / 2 shards (shard s on cuda:s, so each process's local shard 0, the
    one that calls NCCL, has a card of its own). Every shard of every
    operator of torch_mp_worker.run_ops (int64 and int16 keys, int16
    values whose sums wrap, float64 values with nulls, each a multiple of
    1/4) equals bit for bit the same shard of the in-process mesh of as
    many shards, placed as make_mesh places them."""
    import torch_mp_worker as mpw
    from libgdf_tpu_torch import Table
    from libgdf_tpu_torch import parallel as par
    cards = torch.cuda.device_count()
    procs, local = 1, 8
    if layout == "2 processes":
        if cards < 2:
            pytest.skip(f"2 processes with a card each need 2 cards; this "
                        f"machine has {cards}")
        procs, local = 2, cards // 2
    rows = 20_000
    mpw.run_workers(procs, "--local-shards", str(local), "--out",
                    str(tmp_path), "--device", "cuda", "--rows", str(rows))
    fact, nulls, dim = mpw.mixed_data(rows)
    mesh = par.make_mesh(procs * local)
    want = mpw.run_ops(
        mesh, par.distribute(Table.from_dict(fact, nulls, device="cpu"),
                             mesh),
        par.distribute(Table.from_dict(dim, device="cpu"), mesh))
    for op in mpw.OPS:
        _same_shards(mpw.load_shards(str(tmp_path), op, mesh.size), want[op],
                     op)


_LEADERS_ON_ONE_CARD = """
import sys
sys.path.insert(0, sys.argv[3])
import torch.distributed as dist
from libgdf_tpu_torch import GDFError, GDFStatus, parallel as par
par.init_distributed(sys.argv[1], 2, int(sys.argv[2]))
try:
    par.make_mesh(2 * int(sys.argv[4]))
except GDFError as e:
    assert e.status == GDFStatus.GDF_INVALID_API_CALL, e
    print("refused")
dist.destroy_process_group()
"""


def test_two_processes_leading_from_one_card_are_refused(dev):
    """2 processes of C shards each on a node of C >= 2 cards,
    make_mesh(2 C): both processes' local shard 0 (the one that calls
    NCCL, which takes one rank a card) on cuda:0. Both raise
    GDF_INVALID_API_CALL in make_mesh, before any collective of the
    mesh."""
    import os
    import sys
    from libgdf_tpu_torch.parallel import procs
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip(f"2 processes on one node's cards need 2 cards; this "
                    f"machine has {cards}")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = procs.start(lambda coord, r: [
        sys.executable, "-c", _LEADERS_ON_ONE_CARD, coord, str(r), root,
        str(cards)], 2, 180)
    assert all("refused" in out for out in outs), outs


# -- the cost probes (libgdf_tpu_torch/probes/), P-1 .. P-14 -----------------

def _same(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_probes_build_their_own_library(dev):
    """The operators' built library exports none of the probes' entry
    points; the probes' exports all of theirs and its own error string."""
    import ctypes

    from libgdf_tpu_torch.core.errors import GDFError
    from libgdf_tpu_torch.ops.kernels import _lib
    from libgdf_tpu_torch.probes import _common
    ops = ctypes.CDLL(str(_lib.library_path()))
    probe = ctypes.CDLL(str(_common.LIBRARY.build()))
    assert not [n for n in _common.LIBRARY.signatures
                if n.startswith("gdf_probe_") and hasattr(ops, n)]
    assert all(hasattr(probe, n) for n in _common.LIBRARY.signatures)
    assert all(hasattr(ops, n) for n in _lib.KERNELS.signatures)
    with pytest.raises(GDFError, match="probe: invalid argument"):
        _common.LIBRARY.check(1, "probe")


@pytest.mark.parametrize("blocks", [1, 2, 176])
def test_tile_sort(dev, blocks):
    """Every 65,536-element block sorted by (key, payload), over full-range
    keys and an iota payload; 176 blocks is the probe's 11 x 2^20."""
    from libgdf_tpu_torch.probes import tilesort
    n = blocks * tilesort.BLOCK
    rng = np.random.default_rng(blocks)
    key = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, n)
                          .astype(np.int32), device=dev)
    pay = torch.arange(n, dtype=torch.int32, device=dev)
    ko, po = tilesort.tile_sort(key, pay)
    wk, wp = tilesort.tile_sort_plain(key, pay)
    _same(ko, wk)
    _same(po, wp)
    _same(ko.view(-1, tilesort.BLOCK),
          torch.sort(key.view(-1, tilesort.BLOCK), 1).values)
    _same(key[po.long()], ko)


def test_tile_sort_ties(dev):
    """Keys in [-4, 4) and a permuted, partly negative payload: ties come
    out in signed payload order, across the tile / device-memory stages."""
    from libgdf_tpu_torch.probes import tilesort
    n = 2 * tilesort.BLOCK
    rng = np.random.default_rng(11)
    key = rng.integers(-4, 4, n).astype(np.int32)
    pay = (rng.permutation(n) - 50_000).astype(np.int32)
    ko, po = tilesort.tile_sort(torch.as_tensor(key, device=dev),
                                torch.as_tensor(pay, device=dev))
    for b in range(2):
        s = slice(b * tilesort.BLOCK, (b + 1) * tilesort.BLOCK)
        order = np.lexsort((pay[s], key[s]))
        np.testing.assert_array_equal(ko[s].cpu().numpy(), key[s][order])
        np.testing.assert_array_equal(po[s].cpu().numpy(), pay[s][order])


@pytest.mark.parametrize("case", ["sorted", "reverse", "equal",
                                  "extremes"])
def test_tile_sort_edge_blocks(dev, case):
    """Sorted, reverse-sorted and all-equal blocks, and full-range signed
    keys with payloads at INT32_MIN / INT32_MAX, over 4 blocks."""
    from libgdf_tpu_torch.probes import tilesort
    n = 4 * tilesort.BLOCK
    rng = np.random.default_rng(3)
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    iota = np.arange(n, dtype=np.int32)
    key, pay = {
        "sorted": (iota, iota),
        "reverse": (iota[::-1].copy(), iota),
        "equal": (np.full(n, 7, np.int32),
                  rng.permutation(n).astype(np.int32)),
        "extremes": (rng.integers(lo, hi + 1, n, dtype=np.int64)
                     .astype(np.int32),
                     rng.choice(np.array([lo, hi], np.int32), n)),
    }[case]
    if case == "extremes":
        key[:8] = [lo, hi, lo, hi, -1, 0, lo, hi]
    k, p = torch.as_tensor(key, device=dev), torch.as_tensor(pay, device=dev)
    ko, po = tilesort.tile_sort(k, p)
    wk, wp = tilesort.tile_sort_plain(k, p)
    _same(ko, wk)
    _same(po, wp)


def test_tile_sort_rejects_ragged_n_on_the_card(dev):
    from libgdf_tpu_torch.probes import tilesort
    x = torch.zeros(tilesort.BLOCK + 128, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple of 65536"):
        tilesort.tile_sort(x, x)


def test_tile_sort_is_one_cluster_launch(dev):
    """A wrapper call counts one launch and runs exactly one kernel, the
    cluster sort, on a card that holds at least one 4-CTA cluster."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from libgdf_tpu_torch.probes import _common, tilesort
    assert _common.units(dev.index or 0,
                         "gdf_probe_tile_sort_clusters") > 0
    x = torch.arange(2 * tilesort.BLOCK, dtype=torch.int32, device=dev)
    tilesort.tile_sort(x, x)
    torch.cuda.synchronize()
    before = tilesort.tile_sort.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tilesort.tile_sort(x, x)
        torch.cuda.synchronize()
    assert tilesort.tile_sort.launches == before + 1
    kernels_run = {e.key: e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA}
    if kernels_run:                      # a profile may lose its events
        assert sum(kernels_run.values()) == 1, kernels_run
        assert all("tile_sort_cluster" in k for k in kernels_run)


@pytest.mark.parametrize("tiles", [1, 2, 40_960])
@pytest.mark.parametrize("mask", ["none", "all", "first", "last",
                                  "alternating"])
def test_onehot_compact_edge_masks(dev, tiles, mask):
    from libgdf_tpu_torch.probes import caps
    rng = np.random.default_rng(tiles)
    m = tiles * 256
    pos = np.arange(m) % 256
    keep = {"none": pos < 0, "all": pos >= 0, "first": pos == 0,
            "last": pos == 255, "alternating": pos % 2 == 1}[mask]
    x = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, m).astype(np.int32),
                        device=dev)
    k = torch.as_tensor(keep.astype(np.int32), device=dev)
    _same(caps.cap_onehot_compact(x, k), caps.cap_onehot_compact_plain(x, k))


def test_onehot_compact_empty_and_unaligned(dev):
    """n = 0 launches nothing; views at a 4-byte offset (not 16-byte
    aligned) are taken, through 4-byte loads and stores."""
    from libgdf_tpu_torch.probes import caps
    e = torch.empty(0, dtype=torch.int32, device=dev)
    assert caps.cap_onehot_compact(e, e).shape == (0,)
    rng = np.random.default_rng(9)
    m = 5 * 256
    xb = torch.as_tensor(rng.integers(-99, 99, m + 3).astype(np.int32),
                         device=dev)
    kb = torch.as_tensor((rng.random(m + 3) < 0.4).astype(np.int32),
                         device=dev)
    for off in (1, 2, 3):
        x, k = xb[off:off + m], kb[3 - off:3 - off + m]
        assert x.data_ptr() % 16 or k.data_ptr() % 16
        _same(caps.cap_onehot_compact(x, k),
              caps.cap_onehot_compact_plain(x, k))


def _gather_idx(rng, rows, size, dev):
    """Random indices with 0 and size - 1 in every row, and a few that
    count from the end or fall outside the table."""
    idx = rng.integers(0, size, (rows, 128)).astype(np.int32)
    idx[:, 0], idx[:, 1] = 0, size - 1
    idx[0, 2:7] = [-1, -size, size, -size - 1, -2 ** 31]
    return torch.as_tensor(idx, device=dev)


@pytest.mark.parametrize("rows", [1, 8, 13, 31, 32, 33, 1024, 81_920])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("offset", [0, 1])
def test_lane_gather(dev, rows, dtype, offset):
    """A warp a row, 8 rows a block: one row, the probe's 8, 13, a warp's
    32 rows and either side, P-2's 1024 and 81,920 (more blocks than the
    card holds at once), with negative and out-of-range indices; x, idx
    and out 16-byte aligned, or one element off (the 4-byte path)."""
    from libgdf_tpu_torch.probes import _common, gather
    rng = np.random.default_rng(rows)
    x = _offset_view(_values(rng, rows * 128, dtype, dev).view(rows, 128),
                     offset)
    idx = _offset_view(_gather_idx(rng, rows, 128, dev), offset)
    want = gather.lane_gather_plain(x, idx)
    _same(gather.lane_gather(x, idx), want)
    out = _offset_view(torch.full_like(x, 7), offset)
    _common.launch(gather.lane_gather, "lane_gather",
                   "gdf_probe_lane_gather", x, idx, out, rows,
                   gather.FILL_BITS[dtype])
    _same(out, want)


@pytest.mark.parametrize("rows", [1024, 81_920, 13, 1])
@pytest.mark.parametrize("table_rows", [1, 1024, 1792, 31])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_sublane_gather(dev, rows, table_rows, dtype):
    """Row counts below one chunk, of a few chunks (every SM a chunk) and
    at the main path's scale; tables of 1 row, an odd 31, the probe's 1024
    and the largest slab."""
    from libgdf_tpu_torch.probes import gather
    rng = np.random.default_rng(rows + table_rows)
    x = _values(rng, table_rows * 128, dtype, dev).view(table_rows, 128)
    idx = _gather_idx(rng, rows, table_rows, dev)
    _same(gather.sublane_gather(x, idx), gather.sublane_gather_plain(x, idx))


# flat_take's size edges: one block's slab (S words), then tables whose
# first S words are resident and the rest read through L1 / L2
_S = 49_152
TAKE_EDGES = [(1,), (_S,), (_S + 1,), (2 * _S,), (2 * _S + 1,),
              (4 * _S + 1,), (8 * _S,), (8 * _S + 1,)]


@pytest.mark.parametrize("rows", [8192, 81_920, 13])
@pytest.mark.parametrize("table", [(1 << 16,), (512, 128), (1000,),
                                   (100_000,)] + TAKE_EDGES)
def test_flat_take(dev, rows, table):
    """The probe's 64K table, its (512, 128) view, a table of one partial
    slab, one past two slabs, and every size edge of take_plan."""
    from libgdf_tpu_torch.probes import gather
    rng = np.random.default_rng(rows)
    t = _values(rng, int(np.prod(table)), torch.float32, dev).view(table)
    idx = _gather_idx(rng, rows, t.numel(), dev)
    _same(gather.flat_take(t, idx), gather.flat_take_plain(t, idx))


@pytest.mark.parametrize("table", [(1 << 16,), (1000,), (150_000,)] +
                         TAKE_EDGES)
def test_flat_take_int32_views_and_odd_counts(dev, table):
    """int32 values; tables and indices whose data_ptr is not 16-byte
    aligned (t[1:], idx[3:]) and index counts that are not a multiple of 4,
    at every size edge: one launch a call, equal to the plain version."""
    from libgdf_tpu_torch.probes import gather
    rng = np.random.default_rng(int(np.prod(table)))
    base = _values(rng, int(np.prod(table)) + 1, torch.int32, dev)
    idx = _gather_idx(rng, 40, base.numel() - 1, dev).reshape(-1)
    for t in (base[:-1].view(table), base[1:]):
        for i in (idx, idx[3:], idx[1:6], idx[:7], idx[3:4]):
            before = gather.flat_take.launches
            _same(gather.flat_take(t, i), gather.flat_take_plain(t, i))
            assert gather.flat_take.launches == before + 1


def test_sublane_gather_unaligned_table(dev):
    """A table whose data_ptr is not 16-byte aligned is staged by plain
    loads, and gathers as the plain version does."""
    from libgdf_tpu_torch.probes import gather
    rng = np.random.default_rng(3)
    base = _values(rng, 1024 * 128 + 1, torch.float32, dev)
    x = base[1:].view(1024, 128)
    idx = _gather_idx(rng, 1000, 1024, dev)
    _same(gather.sublane_gather(x, idx), gather.sublane_gather_plain(x, idx))


def test_sublane_gather_refuses_a_table_over_shared_memory(dev):
    from libgdf_tpu_torch.probes import gather
    x = torch.zeros((gather.MAX_SUBLANE_ROWS + 1, 128), device=dev)
    with pytest.raises(ValueError):
        gather.sublane_gather(x, torch.zeros((8, 128), dtype=torch.int32,
                                             device=dev))


@pytest.mark.parametrize("shift", [0, 1, 31, 32, 33, 64, 127])
@pytest.mark.parametrize("reps", [1, 1024])
def test_roll_dynamic(dev, shift, reps):
    from libgdf_tpu_torch.probes import roll
    x = torch.arange(512 * 128, dtype=torch.int32, device=dev).view(512, 128)
    s = torch.full((roll.SHIFTS,), shift, dtype=torch.int32, device=dev)
    _same(roll.roll_dynamic(s, x, reps), roll.roll_dynamic_plain(s, x, reps))


@pytest.mark.parametrize("reps", [0, 1, 7, 8, 1024])
@pytest.mark.parametrize("rows", [512, 13])
def test_roll_static_and_mixed_shifts(dev, reps, rows):
    from libgdf_tpu_torch.probes import roll
    rng = np.random.default_rng(reps)
    x = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, (rows, 128))
                        .astype(np.int32), device=dev)
    _same(roll.roll_static(x, reps), roll.roll_static_plain(x, reps))
    s = torch.tensor([0, 32, 64, 96, 127, -1, -129, 200], dtype=torch.int32,
                     device=dev)
    _same(roll.roll_dynamic(s, x, reps), roll.roll_dynamic_plain(s, x, reps))


# Rows ragged against a 4-warp block (and against 2 rows a warp), the tails
# of the static unroll by 7 and the dynamic one by 8, and the dynamic
# shift edges: r = 0 .. 3 at q = 0 and q = 31, multiples of 4 and of 32,
# negatives, 128 and over, all 8 equal.
ROLL_ROWS = [1, 3, 4, 5, 127, 129, 513, 4097]
ROLL_REPS = [0, 1, 2, 6, 7, 8, 9, 15, 16, 1023, 1024, 1025]
ROLL_SHIFTS = [[0, 1, 2, 3, 124, 125, 126, 127],
               [4, 8, 32, 64, 96, 128, 256, 12],
               [-1, -2, -3, -4, -127, -128, -129, -300],
               [128, 129, 131, 255, 383, 1000, 2 ** 31 - 1, -2 ** 31],
               [5] * 8, [126] * 8]


@pytest.mark.parametrize("reps", ROLL_REPS)
@pytest.mark.parametrize("rows", ROLL_ROWS)
def test_roll_edges(dev, rows, reps):
    from libgdf_tpu_torch.probes import roll
    rng = np.random.default_rng(rows * 2048 + reps)
    x = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, (rows, 128))
                        .astype(np.int32), device=dev)
    _same(roll.roll_static(x, reps), roll.roll_static_plain(x, reps))
    for shifts in ROLL_SHIFTS:
        s = torch.tensor(shifts, dtype=torch.int32, device=dev)
        _same(roll.roll_dynamic(s, x, reps),
              roll.roll_dynamic_plain(s, x, reps))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_roll_unaligned_rows(dev, offset):
    """A contiguous view 4-12 bytes off a 16-byte boundary takes the
    kernels' 4-byte accesses."""
    from libgdf_tpu_torch.probes import roll
    rng = np.random.default_rng(offset)
    base = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, 37 * 128 + 4)
                           .astype(np.int32), device=dev)
    x = base[offset:offset + 37 * 128].view(37, 128)
    s = torch.tensor([3, -1, 0, 127, 128, 40, 2, 9], dtype=torch.int32,
                     device=dev)
    for reps in (9, 1024):
        _same(roll.roll_static(x, reps), roll.roll_static_plain(x, reps))
        _same(roll.roll_dynamic(s, x, reps),
              roll.roll_dynamic_plain(s, x, reps))


@pytest.mark.parametrize("name", ["p1", "p2", "p3", "p4", "p5", "p6", "p7"])
def test_caps_on_the_probes_inputs(dev, name):
    """Each capability kernel against its plain version and the probe's
    own check (p6 against 4096)."""
    from libgdf_tpu_torch.probes import caps
    caps.run_probe(name, dev)


def test_caps_on_random_inputs(dev):
    from libgdf_tpu_torch.probes import caps
    rng = np.random.default_rng(17)

    def ints(*shape):
        return torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, shape)
                               .astype(np.int32), device=dev)
    for x00 in (-3, 0, 7, 21):
        x = ints(32, 128)
        x[0, 0] = x00
        _same(caps.cap_dyn_store(x), caps.cap_dyn_store_plain(x))
    for rows in (1, 37, 64):
        x = ints(rows, 128)
        _same(caps.cap_cumsum2d(x), caps.cap_cumsum2d_plain(x))
    for tiles, p in ((1, 0.0), (3, 1.0), (4096, 0.5)):
        x = ints(tiles * 256)
        keep = torch.as_tensor((rng.random(tiles * 256) < p)
                               .astype(np.int32), device=dev)
        _same(caps.cap_onehot_compact(x, keep),
              caps.cap_onehot_compact_plain(x, keep))
    for steps in (1, 2, 10):
        x = ints(8 * steps, 128)
        r = caps.bulk_rows(steps)
        _same(caps.cap_bulk_copy(x)[:r], caps.cap_bulk_copy_plain(x)[:r])
    for tiles in (1, 4, 100):
        x = ints(8 * tiles, 128)
        _same(caps.cap_carry(x), caps.cap_carry_plain(x))
    for x00 in (-3, 0, 6, 2 ** 31 - 1):
        x = ints(8, 300)
        x[0, 0] = x00
        _same(caps.cap_dyn_loop(x), caps.cap_dyn_loop_plain(x))


def test_cap_dyn_store_outside_the_scratch_raises(dev):
    from libgdf_tpu_torch.probes import caps
    x = torch.zeros((16, 128), dtype=torch.int32, device=dev)
    x[0, 0] = 22
    with pytest.raises(ValueError, match="outside"):
        caps.cap_dyn_store(x)


def test_probe_launch_counts(dev):
    """One call of each probe wrapper on the card counts one launch."""
    from libgdf_tpu_torch import probes
    from libgdf_tpu_torch.probes import caps
    probes.reset_launch_counts()
    x = torch.arange(128 * 128, dtype=torch.int32, device=dev)
    m = x.view(128, 128)
    probes.wrappers()["tile_sort"](torch.arange(1 << 16, dtype=torch.int32,
                                                device=dev),
                                   torch.arange(1 << 16, dtype=torch.int32,
                                                device=dev))
    gather_idx = m % 128
    probes.wrappers()["lane_gather"](m, gather_idx)
    probes.wrappers()["sublane_gather"](m, gather_idx)
    probes.wrappers()["flat_take"](x, gather_idx)
    probes.wrappers()["roll_static"](m, 3)
    probes.wrappers()["roll_dynamic"](m[0, :8].contiguous(), m, 3)
    for name in ("p1", "p2", "p3", "p4", "p6", "p7"):
        caps.run_probe(name, dev)
    assert probes.launch_counts() == dict.fromkeys(probes.wrappers(), 1)


@pytest.mark.parametrize("rows", [1, 63, 64])
@pytest.mark.parametrize("aligned", [True, False])
def test_cap_cumsum2d_edges(dev, rows, aligned):
    """P-9 at one row, one row short of the 64-row tile and the full tile,
    over full-range int32 (every column and row sum wraps); a view that
    starts one element in takes the 4-byte path."""
    from libgdf_tpu_torch.probes import caps
    rng = np.random.default_rng(rows)
    x = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, (rows, 128))
                        .astype(np.int32), device=dev)
    if not aligned:
        buf = torch.empty(rows * 128 + 1, dtype=torch.int32, device=dev)
        buf[1:] = x.view(-1)
        x = buf[1:].view(rows, 128)
    _same(caps.cap_cumsum2d(x), caps.cap_cumsum2d_plain(x))


def _offset_view(x, offset):
    """x's values in a view `offset` int32 elements into a new buffer (1:
    not 16-byte aligned)."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    buf[offset:] = x.reshape(-1)
    return buf[offset:].view(x.shape)


def _launch_cap(name, entry, x, out, *args):
    """A cap kernel's C entry point on a given `out` (the wrappers allocate
    theirs, always aligned)."""
    from libgdf_tpu_torch.probes import _common, caps
    _common.launch(getattr(caps, name), name, entry, x, out, *args)
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("steps", [1, 2, 3, 1000, 2 ** 17])
@pytest.mark.parametrize("x_off,out_off", [(0, 0), (1, 0), (0, 1), (1, 3)])
def test_cap_bulk_copy_edges(dev, steps, x_off, out_off):
    """P-11 at one step, two, the probe's 3, 1000 and the wrapper's most
    (2^17), over full-range int32 (+ 1000 wraps); x and out at 16-byte
    aligned and unaligned offsets; the rows past bulk_rows stay as they
    were."""
    from libgdf_tpu_torch.probes import caps
    rng = np.random.default_rng(steps)
    x = _offset_view(torch.as_tensor(rng.integers(
        -2 ** 31, 2 ** 31, (8 * steps, 128)).astype(np.int32), device=dev),
        x_off)
    r = caps.bulk_rows(steps)
    want = caps.cap_bulk_copy_plain(x)[:r]
    if out_off == 0:
        _same(caps.cap_bulk_copy(x)[:r], want)
    out = _offset_view(torch.full_like(x, 7), out_off)
    _launch_cap("cap_bulk_copy", "gdf_probe_cap_bulk_copy", x, out, steps)
    _same(out[:r], want)
    assert bool((out[r:] == 7).all())


@pytest.mark.parametrize("rows", [8, 16, 32])
@pytest.mark.parametrize("x00", [-3, 0, 21])
@pytest.mark.parametrize("offset", [0, 1])
def test_cap_dyn_store_edges(dev, rows, x00, offset):
    """P-8 at row offsets 0, 3 and 24 (the last whose 8 rows fit), rows 8,
    16 and 32 (the whole scratch), x and out aligned and not."""
    from libgdf_tpu_torch.probes import caps
    rng = np.random.default_rng(rows + x00)
    x = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, (rows, 128))
                        .astype(np.int32), device=dev)
    x[0, 0] = x00
    x = _offset_view(x, offset)
    want = caps.cap_dyn_store_plain(x)
    _same(caps.cap_dyn_store(x), want)
    out = _offset_view(torch.full_like(x, 7), offset)
    _same(_launch_cap("cap_dyn_store", "gdf_probe_cap_dyn_store", x, out,
                      rows), want)


@pytest.mark.parametrize("x00", [-4, 22, 2 ** 31 - 1, -2 ** 31])
def test_cap_dyn_store_outside_offsets_raise(dev, x00):
    """Offsets whose 8 rows leave the scratch raise in the wrapper, before
    any launch; the kernel itself stores only zeros for them."""
    from libgdf_tpu_torch.probes import caps
    x = torch.ones((32, 128), dtype=torch.int32, device=dev)
    x[0, 0] = x00
    before = caps.cap_dyn_store.launches
    with pytest.raises(ValueError, match="outside"):
        caps.cap_dyn_store(x)
    assert caps.cap_dyn_store.launches == before
    out = _launch_cap("cap_dyn_store", "gdf_probe_cap_dyn_store", x,
                      torch.full_like(x, 7), 32)
    assert not out.any()


@pytest.mark.parametrize("cols", sorted({1, 3, 4, 127, 128, 129, 4096, 4097,
                                         65_536, LOOP_ALL_ROWS_COLS - 1,
                                         LOOP_ALL_ROWS_COLS,
                                         LOOP_ALL_ROWS_COLS + 1}))
@pytest.mark.parametrize("offset", [0, 1])
def test_cap_dyn_loop_edges(dev, cols, offset):
    """P-14 at every trip count (x[0, 0] & 7 from 0 to 7, and -3 and both
    int32 extremes) over full-range int32 whose sums wrap: the wrapper's
    route, and both routes through the C entry point, at widths either
    side of a quad and of the route's threshold; x and out aligned, or
    one element off (the 4-byte path; so is any cols % 4 != 0)."""
    from libgdf_tpu_torch.probes import caps
    rng = np.random.default_rng(cols)
    x = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, (8, cols))
                        .astype(np.int32), device=dev)
    for x00 in list(range(8)) + [-3, -2 ** 31, 2 ** 31 - 1]:
        x[0, 0] = x00
        xv = _offset_view(x, offset)
        want = caps.cap_dyn_loop_plain(xv)
        _same(caps.cap_dyn_loop(xv), want)
        for all_rows in (1, 0):
            out = _offset_view(torch.full((1, cols), 7, dtype=torch.int32,
                                          device=dev), offset)
            _same(_launch_cap("cap_dyn_loop", "gdf_probe_cap_dyn_loop", xv,
                              out, cols, all_rows), want)


@pytest.mark.parametrize("tiles", [1, 4, 1000])
@pytest.mark.parametrize("aligned", [True, False])
def test_cap_carry_edges(dev, tiles, aligned):
    """P-13 at one tile, the probe's 4 and 1000 (many 16 KB chunks), over
    full-range int32 whose sum wraps."""
    from libgdf_tpu_torch.probes import caps
    rng = np.random.default_rng(tiles)
    x = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, (8 * tiles, 128))
                        .astype(np.int32), device=dev)
    if not aligned:
        buf = torch.empty(x.numel() + 1, dtype=torch.int32, device=dev)
        buf[1:] = x.view(-1)
        x = buf[1:].view(8 * tiles, 128)
    _same(caps.cap_carry(x), caps.cap_carry_plain(x))


# -- the operators' repairs C3-C6 (ROADMAP queue C): the card against the
# port's own CPU run on the same inputs --------------------------------------

def _tables(cols, nulls, dev):
    from libgdf_tpu_torch.interop import from_numpy
    return (from_numpy(cols, nulls, device=dev),
            from_numpy(cols, nulls, device="cpu"))


def _same_column(got, want):
    _same(got.data.cpu(), want.data)
    assert (got.valid is None) == (want.valid is None)
    if want.valid is not None:
        assert torch.equal(got.valid.cpu(), want.valid)


def _denormal_values(rng, dtype, n):
    d = 1e-40 if dtype == np.float32 else 1e-310
    tiny = np.finfo(dtype).tiny
    return rng.choice(np.array([0.0, -0.0, d, -d, 2 * d, tiny, -tiny, 1.5,
                                -1.5, 3.0, np.nan, np.inf], dtype), n)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_denormal_compares_and_divisions_on_the_card(dev, dtype):
    """C3 / C6: comparisons, div and floordiv of denormals against the same
    dtype, the other float dtype and int32 / int64, both ways round."""
    from libgdf_tpu_torch import Column, ops
    n = 1_000_000
    rng = np.random.default_rng(31)
    other = np.float64 if dtype == np.float32 else np.float32
    ints = rng.integers(-3, 4, n)
    x = _denormal_values(rng, dtype, n)
    for p in (_denormal_values(rng, dtype, n),
              _denormal_values(rng, other, n), ints.astype(np.int32),
              ints.astype(np.int64)):
        for a, b in ((x, p), (p, x)):
            ga, gb = (Column.from_array(v, device=dev) for v in (a, b))
            ca, cb = (Column.from_array(v, device="cpu") for v in (a, b))
            for op in ("eq", "ne", "lt", "le", "gt", "ge", "div",
                       "floordiv"):
                _same_column(ops.binary_op(ga, gb, op),
                             ops.binary_op(ca, cb, op))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_identity_hash_of_floats_on_the_card(dev, dtype):
    """C4: the saturating float -> uint32 of the identity hash, with inf,
    NaN, negatives and values past 2^32 (no float -> int64 conversion of
    inf or NaN, which is undefined on the card)."""
    from libgdf_tpu_torch.ops import hashing
    rng = np.random.default_rng(32)
    edges = np.array([-1.0, -0.5, -0.0, 0.5, 2.7, np.inf, -np.inf, np.nan,
                      5e9, 2.0 ** 32, 4294967040.0, 1e-40], dtype)
    x = np.concatenate([edges, (rng.standard_normal(1_000_000) * 3e9)
                        .astype(dtype)])
    a = rng.integers(-5, 5, x.size).astype(np.int64)
    for cols in ([x], [a, x]):
        got = hashing.hash_columns([torch.as_tensor(c, device=dev)
                                    for c in cols], "identity")
        want = hashing.hash_columns([torch.as_tensor(c) for c in cols],
                                    "identity")
        assert torch.equal(got.cpu(), want)


def test_groupby_denormal_min_max_on_the_card(dev):
    """C3: float32 group min / max read a denormal as zero."""
    from libgdf_tpu_torch import ops
    n = 1_000_000
    rng = np.random.default_rng(33)
    cols = {"k": rng.integers(0, 1000, n).astype(np.int32),
            "v": _denormal_values(rng, np.float32, n)}
    cols["v"][np.isnan(cols["v"])] = 1.0
    nulls = {"v": rng.random(n) < 0.1}
    gt, ct = _tables(cols, nulls, dev)
    aggs = [("v", "min", "lo"), ("v", "max", "hi")]
    g = ops.groupby(gt, ["k"], aggs).compact()
    c = ops.groupby(ct, ["k"], aggs).compact()
    assert g.capacity == c.capacity
    for name in ("k", "lo", "hi"):
        _same_column(g[name], c[name])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("frame", ["running", "rows", "range"])
def test_window_denormal_min_max_on_the_card(dev, dtype, frame):
    """C3: window min / max over denormals in frames longer than one H3
    tile (the running scan, a 10,000-row ladder, a RANGE sparse table)."""
    from libgdf_tpu_torch import ops
    n = 300_000
    rng = np.random.default_rng(34)
    d = 1e-40 if dtype == np.float32 else 1e-310
    cols = {"p": rng.integers(0, 20, n).astype(np.int32),
            "o": rng.permutation(n).astype(np.int32),
            "v": rng.choice(np.array([d, -d, 2 * d, 0.0, -0.0,
                                      np.finfo(dtype).smallest_subnormal],
                                     dtype), n)}
    cols["v"][rng.random(n) < 1e-5] = np.nan
    nulls = {"v": rng.random(n) < 0.1}
    gt, ct = _tables(cols, nulls, dev)
    kw = {"running": {}, "rows": dict(preceding=10_000),
          "range": dict(preceding=20_000, frame="range")}[frame]
    for red in ("min", "max"):
        _same_column(
            ops.window_function(gt, "v", red, partition_by=["p"],
                                order_by=["o"], **kw),
            ops.window_function(ct, "v", red, partition_by=["p"],
                                order_by=["o"], **kw))


@pytest.mark.parametrize("first_nan", [4095, 4096, 8191, 8192, 8193,
                                       61 * 8192 - 1, 999_999, None])
def test_window_running_min_nan_across_tiles(dev, first_nan):
    """C5: a float64 running min propagates NaN from its first NaN on; the
    NaN flag is a segmented max that crosses H3's tile look-back. One
    partition of 1M rows in order, the first NaN just before or after a
    tile edge (4096 8-byte or 8192 4-byte elements); None: partitions of
    3001 rows, NaN and NULL at random."""
    from libgdf_tpu_torch import ops
    n = 1_000_000
    rng = np.random.default_rng(35)
    cols = {"o": np.arange(n, dtype=np.int32),
            "v": rng.standard_normal(n)}
    nulls = None
    if first_nan is None:
        cols["p"] = (np.arange(n) // 3001).astype(np.int32)
        cols["v"][rng.random(n) < 1e-3] = np.nan
        nulls = {"v": rng.random(n) < 0.05}
        part = ["p"]
    else:
        cols["v"][first_nan] = np.nan
        cols["v"][first_nan + 1::7919] = np.nan
        part = []
    gt, ct = _tables(cols, nulls, dev)
    got = {}
    for red in ("min", "max"):
        got[red] = ops.window_function(gt, "v", red, partition_by=part,
                                       order_by=["o"])
        _same_column(got[red], ops.window_function(
            ct, "v", red, partition_by=part, order_by=["o"]))
    if first_nan is not None:
        # np.minimum.accumulate propagates NaN, as the reference does
        np.testing.assert_array_equal(got["min"].data.cpu().numpy(),
                                      np.minimum.accumulate(cols["v"]))


# ---------------------------------------------------------------------------
# H5 dense_groupby and its domain probe
# ---------------------------------------------------------------------------

def _groupby_module():
    import importlib
    return importlib.import_module("libgdf_tpu_torch.ops.groupby")


def _q1_table(dev, n, live, seed):
    """Q1's group-by input at scale: l_returnflag, l_linestatus as int8 of
    3 and 2 values on the live rows (stale codes 7 past them), the five
    float64 columns, `live` rows of capacity `n`."""
    from libgdf_tpu_torch import Table
    g = torch.Generator(device=dev).manual_seed(seed)

    def codes(k):
        c = torch.randint(0, k, (n,), generator=g, device=dev,
                          dtype=torch.int8)
        c[live:] = 7
        return c

    def prices(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=g, device=dev,
                                           dtype=torch.float64)
    cols = {"l_returnflag": codes(3), "l_linestatus": codes(2),
            "l_quantity": torch.randint(1, 51, (n,), generator=g,
                                        device=dev).double(),
            "l_extendedprice": prices(900.0, 105_000.0),
            "l_discount": prices(0.0, 0.1),
            "disc_price": prices(800.0, 100_000.0),
            "charge": prices(800.0, 110_000.0)}
    return Table.from_dict(cols).with_num_rows(torch.tensor(live,
                                                            device=dev))


def _q1_plan(t):
    from gdfbench.queries import q1
    G = _groupby_module()
    keys = [t.column(k) for k in q1.KEYS]
    plan = G._dense_plan(t, keys, q1.AGGS, True)
    assert plan is not None and plan.slots == 6
    return plan


def _same_dense(got, want, plan, exact):
    (go, gk, gl, gg), (wo, wk, wl, wg) = got, want
    g = int(wg)
    assert int(gg) == g and torch.equal(gl[:g].cpu(), wl[:g].cpu())
    assert bool(gl[:g].all())
    for o, a, b in zip(plan.outs, go, wo):
        a, b = a[:g].cpu(), b[:g].cpu()
        assert a.dtype == b.dtype
        if exact or not a.dtype.is_floating_point:
            assert torch.equal(a, b), (o, a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-12, atol=0)
    for a, b in zip(gk, wk):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a[:g].cpu(), b[:g].cpu())


def test_dense_groupby_matches_plain_at_q1_scale(dev):
    """H5 against its plain version at 16M live rows of a 17M capacity:
    6 slots, Q1's 8 aggregates (5 float64 sums, the rows)."""
    plan = _q1_plan(_q1_table(dev, 17_000_003, 16_777_259, 5))
    _same_dense(kernels.dense_groupby(plan),
                kernels.dense_groupby_plain(plan), plan, exact=False)


def test_dense_groupby_is_bit_identical_run_to_run(dev):
    plan = _q1_plan(_q1_table(dev, 16_777_216, 16_000_000, 6))
    first = kernels.dense_groupby(plan)
    for _ in range(3):
        _same_dense(kernels.dense_groupby(plan), first, plan, exact=True)


def test_dense_groupby_launches_once_a_q1_groupby(dev):
    """Each Q1 group-by is one probe and one H5 launch, and none of the
    sort path's kernels."""
    from gdfbench.queries import q1
    from libgdf_tpu_torch import ops
    t = _q1_table(dev, 100_003, 99_000, 7)
    kernels.reset_launch_counts()
    for i in range(3):
        ops.groupby(t, q1.KEYS, q1.AGGS)
        counts = kernels.launch_counts()
        assert counts["dense_groupby"] == counts["domain_probe"] == i + 1
        assert counts["seg_scan"] == counts["compact"] == 0


def _quarters(rng, n, dtype, dev, specials=False):
    v = rng.integers(-4000, 4000, n) / 4
    if specials:
        tiny = np.finfo(np.float32 if dtype == torch.float32
                        else np.float64).tiny
        v[::7] = tiny / 8
        v[3::11] = -tiny / 2
    return torch.as_tensor(v, device=dev).to(dtype)


DENSE_CASES = ["int8", "int16", "int32", "int64", "date32", "one_slot",
               "eight_slots", "const_key", "nullable", "null_keys",
               "denormals", "int8_wrap", "unaligned", "no_live_row",
               "over_the_cap"]


@pytest.mark.parametrize("case", DENSE_CASES)
def test_dense_groupby_matches_the_sort_path(dev, case):
    """The group-by on the card, both paths over the same table (sums of
    quarters, exact in any order): keys, sums, counts, averages and
    validity equal; the dispatch as the case wants it."""
    from libgdf_tpu_torch import Column, GDFDtype, Table
    from libgdf_tpu_torch.utils import tracing
    G = _groupby_module()
    rng = np.random.default_rng(DENSE_CASES.index(case))
    n, live = 100_003, 99_001
    kdt = {"int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "date32": torch.int32}.get(case,
                                                           torch.int8)
    span = {"one_slot": 1, "eight_slots": 8, "over_the_cap": 9}.get(case, 3)
    k0 = torch.as_tensor(rng.integers(0, span, n) - 40, device=dev).to(kdt)
    k1 = torch.as_tensor(rng.integers(0, 1 if span > 3 else 2, n) + 5,
                         device=dev).to(kdt)
    if case == "const_key":
        k0.fill_(9)
    k0[live:] = 100                 # stale keys past the live rows
    vals = {"f64": _quarters(rng, n, torch.float64, dev, case == "denormals"),
            "f32": _quarters(rng, n, torch.float32, dev, case == "denormals"),
            "i32": torch.as_tensor(rng.integers(-9, 9, n), device=dev
                                   ).to(torch.int32),
            "i8": torch.as_tensor(rng.integers(-128, 128, n), device=dev
                                  ).to(torch.int8)}
    if case == "int8_wrap":
        vals["i8"].fill_(100)
    cols = [Column.from_array(k0, name="k0", gdf_dtype=GDFDtype.DATE32
                              if case == "date32" else None),
            Column.from_array(k1, name="k1")]
    for name, v in vals.items():
        valid = None
        if case == "nullable":
            valid = torch.as_tensor(rng.random(n) < 0.8, device=dev)
        if case == "unaligned":
            v = torch.cat([v[:1], v])[1:]          # a view off 16 bytes
        cols.append(Column.from_array(v, valid=valid, name=name))
    if case == "null_keys":
        cols[0] = Column.from_array(k0, valid=torch.as_tensor(
            rng.random(n) < 0.9, device=dev), name="k0")
    t = Table.from_columns(cols, num_rows=torch.tensor(
        0 if case == "no_live_row" else live, device=dev))
    aggs = [("f64", "sum", "s64"), ("f64", "avg", "a64"),
            ("f32", "sum", "s32"), ("f32", "count", "c32"),
            ("f32", "avg", "a32"), ("i32", "avg", "ai"),
            ("i8", "sum", "s8"), ("i8", "count", "c8"), ("i8", "avg", "a8"),
            ("k1", "count", "n")]
    if case == "nullable":
        aggs = aggs[:6]             # 8 accumulators with the validity counts
    keys = ["k0", "k1"]
    tracing.reset_counters()
    got = G._groupby_impl(t, keys, aggs, True)
    dense_wanted = case not in ("over_the_cap", "no_live_row")
    assert tracing.counters().get("groupby.dense", 0) == int(dense_wanted)
    assert tracing.counters().get("groupby.wide", 0) == int(
        case == "over_the_cap")
    want = G._sort_groupby(t, keys, [t.column(k) for k in keys], aggs, True)
    g = int(want.num_rows)
    assert int(got.num_rows) == g and got.capacity == want.capacity
    for a, b in zip(got.columns, want.columns):
        assert (a.name, a.info, a.data.dtype) == (b.name, b.info, b.data.dtype)
        assert (a.valid is None) == (b.valid is None)
        va = None if a.valid is None else a.valid[:g].cpu()
        vb = None if b.valid is None else b.valid[:g].cpu()
        if va is not None:
            assert torch.equal(va, vb), a.name
        da, db = a.data[:g].cpu(), b.data[:g].cpu()
        if vb is not None:
            da, db = da[vb], db[vb]
        assert torch.equal(da, db), (a.name, da, db)


def test_dense_groupby_host_waits_are_its_counted_read(dev):
    """torch's sync debug mode: the dense and the wide path wait once (the
    domain read) and a probed input that takes the sort path once; an
    input the probe never sees (a min) not at all."""
    import warnings
    from libgdf_tpu_torch import ops
    from libgdf_tpu_torch.utils import tracing
    from libgdf_tpu_torch import Column
    small = _q1_table(dev, 100_003, 99_000, 8)
    wide = small.replace_column("l_returnflag", Column.from_array(
        torch.arange(100_003, device=dev).to(torch.int32),
        name="l_returnflag"))
    spread = small.replace_column("l_returnflag", Column.from_array(
        torch.arange(100_003, device=dev).to(torch.int32) * 64,
        name="l_returnflag"))
    cases = [(small, [("l_quantity", "sum", "s")], 1, "groupby.dense"),
             (small, [("l_quantity", "min", "m")], 0, "groupby.sort"),
             (wide, [("l_quantity", "sum", "s")], 1, "groupby.wide"),
             (spread, [("l_quantity", "sum", "s")], 1, "groupby.sort")]
    for t, aggs, waits, path in cases:
        torch.cuda.synchronize()
        tracing.reset_counters()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                ops.groupby(t, ["l_returnflag", "l_linestatus"], aggs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [w for w in seen
                 if "called a synchronizing" in str(w.message)]
        c = tracing.counters()
        assert len(syncs) == c["host_sync"] == waits, (path, syncs, c)
        assert c[path] == 1


# ---------------------------------------------------------------------------
# H7 wide_groupby
# ---------------------------------------------------------------------------

def _q18_table(dev, seed, orders=15_000_000, shuffle=False):
    """Q18's subquery input at SF 10: l_orderkey as TPC-H makes order keys
    (the first 8 of every 32: 1 to 59,999,976), 1 to 7 lines an order,
    adjacent (or shuffled), l_quantity 1 to 50 as float64."""
    from libgdf_tpu_torch import Table
    g = torch.Generator(device=dev).manual_seed(seed)
    o = torch.arange(orders, device=dev)
    okey = ((o // 8) * 32 + o % 8 + 1).to(torch.int32)
    key = torch.repeat_interleave(okey, torch.randint(
        1, 8, (orders,), generator=g, device=dev))
    qty = torch.randint(1, 51, (key.shape[0],), generator=g,
                        device=dev).double()
    if shuffle:
        perm = torch.randperm(key.shape[0], generator=g, device=dev)
        key, qty = key[perm], qty[perm]
    return Table.from_dict({"l_orderkey": key, "l_quantity": qty})


def _q18_plan(t):
    G = _groupby_module()
    plan = G._dense_plan(t, [t.column("l_orderkey")],
                         [("l_quantity", "sum", "sum_qty")], True)
    assert plan is not None and plan.wide
    return plan


@pytest.mark.parametrize("shuffle", [False, True],
                         ids=["clustered", "shuffled"])
def test_wide_groupby_matches_plain_at_q18_scale(dev, shuffle):
    """H7 against its plain version at Q18's shape: ~60M rows into ~15M
    groups of a ~6.0e7-slot domain. Integer quantities sum exactly in any
    order, so every output is exact."""
    plan = _q18_plan(_q18_table(dev, 11, shuffle=shuffle))
    assert 59_000_000 < plan.slots < 60_000_000
    got = kernels.wide_groupby(plan)
    assert int(got[3]) == 15_000_000
    _same_dense(got, kernels.dense_groupby_plain(plan), plan, exact=True)


def test_wide_groupby_is_bit_identical_run_to_run(dev):
    """Clustered input, float sums of values that do not add exactly: each
    group reaches its slot from at most two warps, so the sums repeat."""
    from libgdf_tpu_torch import Column
    t = _q18_table(dev, 12)
    g = torch.Generator(device=dev).manual_seed(13)
    t = t.replace_column("l_quantity", Column.from_array(
        torch.rand(t.capacity, generator=g, device=dev, dtype=torch.float64),
        name="l_quantity"))
    plan = _q18_plan(t)
    first = kernels.wide_groupby(plan)
    _same_dense(first, kernels.dense_groupby_plain(plan), plan, exact=False)
    for _ in range(3):
        _same_dense(kernels.wide_groupby(plan), first, plan, exact=True)


def test_wide_groupby_launches_no_sort(dev):
    """Q18's subquery group-by is one probe and one H7 call, and none of
    the sort path's kernels: no sort on the card at all; its host waits on
    the probe's read alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from libgdf_tpu_torch import ops
    from libgdf_tpu_torch.utils import tracing
    t = _q18_table(dev, 14, orders=1_000_003)
    kernels.reset_launch_counts()
    tracing.reset_counters()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            ops.groupby(t, ["l_orderkey"],
                        [("l_quantity", "sum", "sum_qty")])
            counts = kernels.launch_counts()
            assert counts["wide_groupby"] == counts["domain_probe"] == i + 1
            assert counts["seg_scan"] == counts["compact"] == 0
            assert counts["dense_groupby"] == 0
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
    assert any("wide_add" in k for k in names), names
    assert not [k for k in names if "sort" in k.lower()], names
    got = tracing.counters()
    assert got["groupby.wide"] == got["host_sync"] == 3
    assert "groupby.sort" not in got


# ---------------------------------------------------------------------------
# H6 hash_build / hash_probe
# ---------------------------------------------------------------------------

def _join_module():
    import importlib
    return importlib.import_module("libgdf_tpu_torch.ops.join")


def _same_h6(bkeys, pkeys, bvalid=None, pvalid=None, brows=None, prows=None):
    """H6 against its plain version on the card: the count and duplicate
    flag exact; without a duplicate, the pairs by probe row, and after the
    operator's order sort, exact. Returns (count, dup)."""
    table = kernels.hash_build(bkeys, bvalid, brows)
    p, b, res = kernels.hash_probe(table, pkeys, pvalid, prows)
    torch.cuda.synchronize()
    plain = kernels.hash_build_plain(bkeys, bvalid, brows)
    pw, bw, rw = kernels.hash_probe_plain(plain, pkeys, pvalid, prows)
    count, dup = res.tolist()
    assert [count, dup] == rw.tolist()
    if dup:
        return count, dup
    p, b, pw, bw = p[:count], b[:count], pw[:count], bw[:count]
    order = torch.argsort(p)
    assert torch.equal(p[order], pw) and torch.equal(b[order], bw)
    J = _join_module()
    for got, want in zip(J._match_order(pkeys, p, b),
                         J._match_order(pkeys, pw, bw)):
        assert torch.equal(got, want)
    return count, dup


def _h6_keys(dev, probe_n, build_n, domain, seed, dtype=torch.int32):
    g = torch.Generator(device=dev).manual_seed(seed)
    build = torch.randperm(domain, generator=g, device=dev)[:build_n]
    probe = torch.randint(0, domain, (probe_n,), generator=g, device=dev)
    return build.to(dtype), probe.to(dtype)


# (probe rows, build rows, key domain): Q18's lineitem join (a 2048-slot
# table in shared memory), Q3's (4M slots in global memory), one build row,
# the largest staged table (2048 rows, 4096 slots) and the smallest that is
# not (2049 rows, 8192 slots)
H6_SHAPES = {"q18": (60_000_000, 100, 15_000_000),
             "q3": (32_000_000, 1_460_000, 60_000_000),
             "one_row": (1_000_003, 1, 3),
             "smem_limit": (4_000_037, 2048, 40_000),
             "past_smem_limit": (4_000_037, 2049, 40_000)}


@pytest.mark.parametrize("shape", list(H6_SHAPES))
def test_hash_join_matches_plain(dev, shape):
    probe_n, build_n, domain = H6_SHAPES[shape]
    bk, pk = _h6_keys(dev, probe_n, build_n, domain, 11)
    count, dup = _same_h6(bk, pk)
    assert not dup and count > 0
    staged = kernels.hash_build(bk).staged
    assert staged == (shape in ("q18", "one_row", "smem_limit"))


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32,
                                   torch.int64, torch.uint8, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("build_n", [100, 50_000])
def test_hash_join_dtypes_nulls_and_dead_rows(dev, dtype, build_n):
    """Every key dtype, null keys and dead rows on both sides (the dead
    and null build rows repeat live keys), unaligned probe keys."""
    rng = np.random.default_rng(build_n + 7)
    domain, low = {torch.int8: (200, -100), torch.uint8: (200, 0),
                   torch.int16: (60_000, -30_000)}.get(dtype,
                                                       (10 * build_n, 0))
    n_b = min(build_n, domain // 2)
    bk, pk = _h6_keys(dev, 1_000_001, n_b, domain, 3, torch.int64)
    bk, pk = (bk + low).to(dtype), (pk + low).to(dtype)
    live_b = n_b - n_b // 5
    bk[live_b:] = bk[:n_b - live_b]
    bvalid = torch.as_tensor(rng.random(n_b) < 0.9, device=dev)
    bk[~bvalid] = bk[0].item()
    pvalid = torch.as_tensor(rng.random(pk.shape[0]) < 0.9, device=dev)
    pk = torch.cat([pk[:1], pk])[1:]            # a view off 16 bytes
    brows = torch.tensor(live_b, dtype=torch.int32, device=dev)
    prows = torch.tensor(900_001, dtype=torch.int32, device=dev)
    count, dup = _same_h6(bk, pk.clone(), bvalid, pvalid, brows, prows)
    assert not dup and count > 0
    count_u, _ = _same_h6(bk, pk, bvalid, pvalid, brows, prows)
    assert count_u == count


def test_hash_join_special_keys(dev):
    """The keys the tables treat apart: an int64 -1 (all ones, a wide
    table's empty slot), 0 (a narrow slot's empty word holds key 0 with no
    row), INT32/INT64 extremes, floats' -0.0, denormals and NaN."""
    i64 = torch.iinfo(torch.int64)
    i32 = torch.iinfo(torch.int32)
    cases = [
        (torch.tensor([-1, 0, i64.min, i64.max, 1 << 32, 5]),
         torch.tensor([-1, 0, i64.min, i64.max, 1 << 32, 7, -1, 2])),
        (torch.tensor([0, i32.min, i32.max, -1], dtype=torch.int32),
         torch.tensor([i32.max, 0, 0, i32.min, 3, -1], dtype=torch.int32)),
        (torch.tensor([-0.0, 1.5, float("nan"), 2.0]),
         torch.tensor([0.0, 5e-324, -2e-320, float("nan"), 1.5, -0.0])),
        (torch.tensor([0.0, 1.5, float("nan")], dtype=torch.float32),
         torch.tensor([-0.0, 1e-40, float("nan"), 1.5, 2.0],
                      dtype=torch.float32)),
    ]
    for bk, pk in cases:
        bk, pk = bk.to(dev), pk.to(dev).repeat(1000)
        count, dup = _same_h6(bk, pk)
        assert not dup and count > 0


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float64])
def test_hash_build_flags_a_duplicate(dev, dtype):
    bk = torch.arange(5000, device=dev).to(dtype)
    bk[4321] = bk[17]
    pk = torch.arange(10_000, device=dev).to(dtype)
    _, dup = _same_h6(bk, pk)
    assert dup == 1


@pytest.mark.parametrize("empty", ["build", "probe", "both"])
def test_hash_join_empty_side_launches_nothing(dev, empty):
    """An empty side launches nothing: an empty build side's table matches
    nothing and launches neither kernel; an empty probe side of a table
    that counted matches before launches no probe and counts 0. Each gives
    the plain version's result."""
    bk, pk = _h6_keys(dev, 10_000, 100, 400, 7)
    table = kernels.hash_build(bk)
    _, _, res = kernels.hash_probe(table, pk)
    assert int(res[0]) > 0
    if empty in ("build", "both"):
        bk = bk[:0]
    if empty in ("probe", "both"):
        pk = pk[:0]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    if empty != "probe":
        table = kernels.hash_build(bk)
    _, _, res = kernels.hash_probe(table, pk)
    counts = kernels.launch_counts()
    assert counts["hash_build"] == counts["hash_probe"] == 0
    assert res.tolist() == [0, 0]
    _, _, rw = kernels.hash_probe_plain(kernels.hash_build_plain(bk), pk)
    assert rw.tolist() == [0, 0]


def test_hash_probe_counts_past_its_capacity(dev):
    bk, pk = _h6_keys(dev, 1_000_000, 1000, 4000, 5)
    table = kernels.hash_build(bk)
    _, _, full = kernels.hash_probe(table, pk)
    count = int(full[0])
    p, b, res = kernels.hash_probe(table, pk, capacity=count // 2)
    assert int(res[0]) == count and p.shape[0] == count // 2
    pw, bw, _ = kernels.hash_probe_plain(kernels.hash_build_plain(bk), pk)
    got = set(zip(p.tolist(), b.tolist()))
    assert got <= set(zip(pw[:count].tolist(), bw[:count].tolist()))
    assert len(got) == count // 2


def test_hash_join_operator_on_the_card(dev):
    """The inner join through the operator on the card against its CPU
    run: identical indices and count; one build and one probe launch and
    none of the sort path's kernels; one host wait (sync debug mode)."""
    import warnings
    from libgdf_tpu_torch import Table, ops
    from libgdf_tpu_torch.utils import tracing
    rng = np.random.default_rng(9)
    n, nb = 2_000_003, 30_000
    left = {"k": rng.integers(0, 120_000, n).astype(np.int32),
            "v": rng.standard_normal(n)}
    right = {"k": rng.permutation(120_000)[:nb].astype(np.int32),
             "w": rng.standard_normal(nb)}
    nulls = {"k": rng.random(n) < 0.05}
    outs = {}
    for d in ("cpu", "cuda"):
        lt = Table.from_dict(left, nulls, device=d).with_num_rows(
            torch.tensor(n - 1000, device=d))
        rt = Table.from_dict(right, device=d)
        if d == "cuda":
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            tracing.reset_counters()
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    li, ri, c = ops.inner_join(lt, rt, ["k"], ["k"])
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs = [w for w in seen
                     if "called a synchronizing" in str(w.message)]
            counts = kernels.launch_counts()
            assert counts["hash_build"] == counts["hash_probe"] == 1
            assert counts["compact"] == counts["seg_scan"] == 0
            assert counts["expand_fill"] == 0
            got = tracing.counters()
            assert len(syncs) == got["host_sync"] == 1, (syncs, got)
            assert got["join.hash"] == 1
        else:
            li, ri, c = ops.inner_join(lt, rt, ["k"], ["k"])
        outs[d] = (li.cpu(), ri.cpu(), int(c))
    assert outs["cpu"][2] == outs["cuda"][2] > 0
    assert torch.equal(outs["cpu"][0], outs["cuda"][0])
    assert torch.equal(outs["cpu"][1], outs["cuda"][1])


# -- H8: add / sub / mul and compare_scalar in one pass -----------------------

# an arithmetic step is 4 elements, a compare step 16: ragged tails of each,
# and TPC-H SF 10's line items (Q1's and Q6's columns)
H8_SIZES = [0, 1, 3, 4, 5, 15, 16, 17, 1023, 100_003]
Q_ROWS = 59_986_052
H8_OPS = ("add", "sub", "mul")
CMP = ("eq", "ne", "lt", "le", "gt", "ge")
FLOATS = (torch.float32, torch.float64)


def _h8_edges(rng, n, dtype, dev):
    """The flush's edge values of a float dtype, or small ints and the
    dtype's ends."""
    if dtype.is_floating_point:
        d = 1e-40 if dtype == torch.float32 else 1e-310
        t = torch.finfo(dtype).tiny
        vals = [0.0, -0.0, d, -d, t, -t, 1.5, -2.25, float("inf"),
                float("-inf"), float("nan")]
    else:
        info = torch.iinfo(dtype)
        vals = [0, 1, -1, 5, 6, info.min, info.max]
    return torch.tensor(vals, dtype=dtype)[
        torch.as_tensor(rng.integers(0, len(vals), n))].to(dev)


def _same_bits(got, want, what=""):
    """Bit-identical but for NaN's payload: NaN where NaN, the sign of a
    zero kept."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), what
    wide = {torch.float32: torch.int32, torch.float64: torch.int64}
    g, w = got.masked_fill(nan, 0), want.masked_fill(nan, 0)
    assert torch.equal(g.view(wide[g.dtype]), w.view(wide[w.dtype])), what


def _h8_operand(rng, n, dtype, dev, broadcast, offset=0):
    if broadcast:
        return _h8_edges(rng, 1, dtype, dev).reshape(()).expand(n)
    return _h8_edges(rng, n + offset, dtype, dev)[offset:]


@pytest.mark.parametrize("n", H8_SIZES)
@pytest.mark.parametrize("da,db", [(a, b) for a in FLOATS for b in FLOATS])
@pytest.mark.parametrize("shape", ["columns", "scalar_a", "scalar_b"])
def test_h8_binary_matches_plain(dev, n, da, db, shape):
    """H8's add / sub / mul equal their plain versions bit for bit, with a
    stride-0 operand on either side, float32 against float64."""
    rng = np.random.default_rng(n)
    for i in range(3 if shape != "columns" else 1):
        a = _h8_operand(rng, n, da, dev, shape == "scalar_a" and n > 1)
        b = _h8_operand(rng, n, db, dev, shape == "scalar_b" and n > 1)
        for op in H8_OPS:
            _same_bits(kernels.elementwise_binary(op, a, b),
                       kernels.elementwise_binary_plain(op, a, b),
                       f"{op} {a.dtype} {b.dtype} {shape} n={n}")


@pytest.mark.parametrize("offsets", [(1, 0), (0, 1), (1, 1), (3, 2)])
def test_h8_binary_unaligned_views(dev, offsets):
    """Views off a 16-byte boundary take the scalar path, and equal the
    plain version."""
    rng = np.random.default_rng(5)
    n = 100_003
    for da, db in ((torch.float64, torch.float64),
                   (torch.float32, torch.float64)):
        a = _h8_operand(rng, n, da, dev, False, offsets[0])
        b = _h8_operand(rng, n, db, dev, False, offsets[1])
        for op in H8_OPS:
            _same_bits(kernels.elementwise_binary(op, a, b),
                       kernels.elementwise_binary_plain(op, a, b),
                       f"{op} {offsets}")


def _h8_scalars(dtype):
    if dtype.is_floating_point:
        return [0.0, -0.0, 1e-40, -1e-40, 1e-310, -1e-310,
                float(torch.finfo(dtype).tiny), 1.5, float("inf"),
                float("nan"), 0, -3, 2 ** 53]
    info = torch.iinfo(dtype)
    return [0, 5, -1, int(info.min), int(info.max), info.max + 45,
            info.min - 300, 0.0, -0.0, 1e-310, 2.5, -1.5, float("nan"),
            float("inf")]


@pytest.mark.parametrize("n", H8_SIZES)
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32,
                                   torch.int64, torch.float32,
                                   torch.float64])
def test_h8_compare_matches_plain(dev, n, dtype):
    """H8's compare against a scalar equals its plain version: every op,
    int and float scalars, zeros, denormals, NaN, inf, ints past the
    column's range (wrapped to it, as torch does) and at offset 1."""
    rng = np.random.default_rng(n + 3)
    for offset in (0, 1):
        x = _h8_edges(rng, n + offset, dtype, dev)[offset:]
        for v in _h8_scalars(dtype):
            if dtype == torch.int64 and isinstance(v, int) and \
                    not -2 ** 63 <= v < 2 ** 63:
                continue
            for op in CMP:
                got = kernels.elementwise_compare(x, op, v)
                assert got.dtype == torch.int8
                assert torch.equal(got, kernels.elementwise_compare_plain(
                    x, op, v)), (dtype, op, v, offset, n)


def test_h8_at_q1_and_q6_shapes(dev):
    """Each operation Q1 and Q6 send through H8, at SF 10's 59,986,052 rows
    (a ragged tail): bit-identical to the plain versions; one launch a
    call, counted by dtype, and `elementwise.h8` once a call."""
    from libgdf_tpu_torch import Column, ops
    from libgdf_tpu_torch.core import DtypeInfo, GDFDtype
    from libgdf_tpu_torch.utils import tracing
    g = torch.Generator(device=dev).manual_seed(3)
    n = Q_ROWS
    f64 = DtypeInfo(GDFDtype.FLOAT64)
    ship = Column(data=torch.randint(8000, 10600, (n,), device=dev,
                                     dtype=torch.int32, generator=g),
                  info=DtypeInfo(GDFDtype.DATE32))
    disc = Column(data=torch.randint(0, 11, (n,), device=dev,
                                     generator=g).double() / 100, info=f64)
    qty = Column(data=torch.randint(1, 51, (n,), device=dev,
                                    generator=g).double(), info=f64)
    price = Column(data=torch.rand(n, device=dev, dtype=torch.float64,
                                   generator=g) * 1e5, info=f64)
    one = Column(data=torch.ones((), dtype=torch.float64,
                                 device=dev).expand(n), info=f64)
    kernels.reset_launch_counts()
    tracing.reset_counters()
    calls = [
        (lambda: ops.compare_scalar(ship, 8766, "ge"), ship, 8766, "ge"),
        (lambda: ops.compare_scalar(ship, 9131, "lt"), ship, 9131, "lt"),
        (lambda: ops.compare_scalar(disc, 0.05, "ge"), disc, 0.05, "ge"),
        (lambda: ops.compare_scalar(disc, 0.07, "le"), disc, 0.07, "le"),
        (lambda: ops.compare_scalar(qty, 24, "lt"), qty, 24, "lt"),
        (lambda: ops.compare_scalar(ship, 10471, "le"), ship, 10471, "le")]
    for run, col, v, op in calls:
        assert torch.equal(run().data, kernels.elementwise_compare_plain(
            col.data, op, v)), (op, v)
    dp = ops.mul(price, ops.sub(one, disc))
    charge = ops.mul(dp, ops.add(one, qty))
    want = kernels.elementwise_binary_plain("mul", price.data,
                                            kernels.elementwise_binary_plain(
                                                "sub", one.data, disc.data))
    _same_bits(dp.data, want, "disc_price")
    _same_bits(charge.data, kernels.elementwise_binary_plain(
        "mul", want, kernels.elementwise_binary_plain("add", one.data,
                                                      qty.data)), "charge")
    _same_bits(ops.mul(price, disc).data, kernels.elementwise_binary_plain(
        "mul", price.data, disc.data), "revenue")
    counts = kernels.launch_counts()
    assert counts["elementwise_compare"] == 6
    assert counts["elementwise_compare[int32]"] == 3
    assert counts["elementwise_compare[float64]"] == 3
    assert counts["elementwise_binary"] == counts[
        "elementwise_binary[float64]"] == 5
    got = tracing.counters()
    assert got["elementwise.h8"] == 11 and "elementwise.torch" not in got


def test_h8_of_no_rows_launches_nothing(dev):
    kernels.reset_launch_counts()
    x = torch.empty(0, dtype=torch.float64, device=dev)
    assert kernels.elementwise_binary("add", x, x).shape == (0,)
    assert kernels.elementwise_compare(x, "lt", 0.0).dtype == torch.int8
    counts = kernels.launch_counts()
    assert counts["elementwise_binary"] == counts["elementwise_compare"] == 0


def test_h8_does_not_wait_on_the_card(dev):
    """No H8 call makes the host wait: torch's sync debug mode sees none."""
    import warnings
    from libgdf_tpu_torch import Column, ops
    x = Column.from_array(np.linspace(-1, 1, 100_003), device="cuda")
    f = Column.from_array(np.linspace(-1, 1, 100_003).astype(np.float32),
                          device="cuda")
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            ops.compare_scalar(ops.sub(x, f), 0.25, "gt")
            ops.compare_scalar(x, 1e-310, "le")
            ops.mul(f, f)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in seen
             if "called a synchronizing" in str(w.message)]
    assert not syncs, syncs
