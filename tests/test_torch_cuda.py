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

SIZES = [1, 2047, 2048, 2049, 100_003, 3_000_000]
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


@pytest.mark.parametrize("cap,density", [
    (1, 1.0), (2048, 0.5), (100_003, 0.1), (3_000_000, 0.9),
    (40_000_000, 0.25)])
def test_expand_fill(dev, cap, density):
    rng = np.random.default_rng(cap)
    nsrc = max(1, int(cap * density))
    pos = np.sort(rng.choice(cap, nsrc, replace=False)).astype(np.int32)
    pos = np.concatenate([pos, np.full(5, kernels.SENTINEL, np.int32)])
    words = [torch.as_tensor(rng.integers(-2**30, 2**30, pos.size)
                             .astype(np.int32), device=dev),
             torch.as_tensor(rng.integers(-2**62, 2**62, pos.size),
                             device=dev)]
    pos_t = torch.as_tensor(pos, device=dev)
    got = kernels.expand_fill(pos_t, words, cap)
    want = kernels.expand_fill_plain(pos_t, words, cap)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


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
