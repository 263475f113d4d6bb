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

pytestmark = pytest.mark.cuda

# The edges of H2's and H3's 32 KB tiles (8192 4-byte or 4096 8-byte
# elements), of H1's 4096-row tiles and of H4's 4096-slot runs, and many
# tiles plus one.
SIZES = [1, 2047, 2048, 2049, 4095, 4096, 4097, 8191, 8192, 8193, 100_003,
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


def test_wrappers_refuse_what_they_cannot_launch(dev):
    x = torch.arange(10, dtype=torch.int16, device=dev)
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
