"""Plain versions of the Hopper kernels against their Pallas originals.

Each plain PyTorch version in libgdf_tpu_torch/ops/kernels is what the
kernel wrapper runs on CPU tensors, and what chip_smoke.py holds the CUDA
kernel to on the card. Here it is held to the Pallas kernel it replaces,
run with interpret=True on a tiny 8x128 block geometry (the monkeypatch of
tests/test_pallas_{compact,scan,expand}.py) so that block boundaries are
crossed at CPU-test sizes.

Tolerances: integers, counts, flags and row order exact; float32 sums
rtol=2e-5, atol=2e-4 (associative scans add in another order, as in
tests/test_pallas_scan.py); float64 sums rtol=1e-12, atol=1e-12 * max|x|
(the Pallas kernels' double-float error is ~2^-47).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libgdf_tpu.ops import sort as jsort
from libgdf_tpu.ops.pallas import compact, compact2, expand
from libgdf_tpu.ops.pallas import scan as ps
from libgdf_tpu_torch.core.errors import GDFError
from libgdf_tpu_torch.ops import engine, kernels
from libgdf_tpu_torch.ops.kernels import _lib
from libgdf_tpu_torch.probes import _common

B = 8 * 128


@pytest.fixture
def tiny(monkeypatch):
    for mod in (compact, compact2, expand, ps):
        monkeypatch.setattr(mod, "ROWS", 8)
        monkeypatch.setattr(mod, "BLOCK", B)
    runs = (compact._run, compact2._run, expand._run, ps._run_val,
            ps._run_pair, ps._run_sum64, ps._run_sumff, ps._run_seg_sum64,
            ps._run_seg_sumff, ps._run_seg_sel64)
    for r in runs:
        r.clear_cache()
    yield
    for r in runs:
        r.clear_cache()


def t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("version,n,p", [
    ("v1", 0, 0.5), ("v1", 3 * B + 17, 0.4), ("v2", 0, 0.5),
    ("v2", B, 0.0), ("v2", B, 1.0), ("v2", 3 * B + 17, 0.4),
    # all, none and one kept over many blocks and a ragged last one
    ("v1", 3 * B + 17, 1.0), ("v1", 3 * B + 17, 0.0),
    ("v1", 3 * B + 17, "one"), ("v2", 3 * B + 17, 1.0),
    ("v2", 3 * B + 17, 0.0), ("v2", 3 * B + 17, "one")])
def test_compact_plain_matches_pallas(tiny, rng, version, n, p):
    if p == "one":
        keep = np.zeros(n, bool)
        keep[2 * B + 5] = True
    else:
        keep = (rng.random(n) < p) if 0 < p < 1 else np.full(n, bool(p))
    arrays = [rng.integers(-2**31, 2**31, n).astype(np.int32),
              rng.standard_normal(n).astype(np.float32),
              rng.integers(-2**62, 2**62, n).astype(np.int64),
              rng.standard_normal(n),          # normal f64: no -0.0/NaN
              rng.random(n) < 0.5]
    run = compact.compact_pallas if version == "v1" else \
        compact2.compact_pallas2
    jouts, jcnt = run([jnp.asarray(a) for a in arrays], jnp.asarray(keep),
                      interpret=True)
    touts, tcnt = kernels.compact_plain([t(a) for a in arrays], t(keep))
    c = int(jcnt)
    assert int(tcnt) == c == int(keep.sum())
    for j, o in zip(jouts, touts):
        np.testing.assert_array_equal(o.numpy()[:c], np.asarray(j)[:c])


@pytest.mark.parametrize("n", [0, 2 * B + 101])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_scan_plain_matches_pallas(tiny, rng, n, dtype):
    x = (rng.integers(-50, 50, n) if dtype == np.int32
         else rng.standard_normal(n)).astype(dtype)
    for kind in ("sum", "max", "min"):
        got = kernels.scan_plain(kind, t(x)).numpy()
        want = np.asarray(ps.scan_pallas(kind, jnp.asarray(x),
                                         interpret=True))
        if kind == "sum" and dtype == np.float32:
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, 2 * B + 101])
def test_scan_plain_matches_pallas_sum64(tiny, rng, n):
    """H2 at int64 (the Hopper form of K4a): exact, wrapping int64 sums.
    Values near +-2^62 make the running sum wrap many times."""
    x = rng.integers(2**62 - 2**40, 2**62, n).astype(np.int64)
    x[rng.random(n) < 0.5] *= -1
    got = kernels.scan_plain("sum", t(x)).numpy()
    want = np.asarray(ps.cumsum64_pallas(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(got, want)
    assert n == 0 or (np.diff(got.astype(np.float64)) * x[1:] < 0).any()


@pytest.mark.parametrize("n", [0, 2 * B + 101])
def test_scan_plain_matches_pallas_sum_f64(tiny, rng, n):
    """H2 at float64 (the Hopper form of K5a) against the double-float
    Pallas kernel (~2^-47 relative)."""
    x = rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))
    got = kernels.scan_plain("sum", t(x)).numpy()
    want = np.asarray(ps.cumsum_f64_pallas(jnp.asarray(x), interpret=True))
    atol = np.abs(x).max() * 1e-12 if n else 0
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=atol)


@pytest.mark.parametrize("n", [0, 2 * B + 101])
@pytest.mark.parametrize("density", [0.0, 0.03, 1.0])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_seg_scan_plain_matches_pallas_pair(tiny, rng, n, density, dtype):
    x = (rng.integers(-50, 50, n) if dtype == np.int32
         else rng.standard_normal(n)).astype(dtype)
    f = rng.random(n) < density
    for kind in ("sum", "max", "min", "carry"):
        got = kernels.seg_scan_plain(kind, t(f), t(x)).numpy()
        want = np.asarray(ps.scan_pallas_pair(kind, jnp.asarray(f),
                                              jnp.asarray(x),
                                              interpret=True))
        if kind == "sum" and dtype == np.float32:
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)
        else:
            np.testing.assert_array_equal(got, want)


# density 0: one segment over every block; 1: every row its own segment
@pytest.mark.parametrize("n,density", [
    pytest.param(0, 0.05, id="0"), pytest.param(2 * B + 101, 0.05, id="2149"),
    (3 * B + 17, 0.0), (3 * B + 17, 1.0)])
def test_seg_sum64_plain_matches_pallas(tiny, rng, n, density):
    x = rng.integers(-2**40, 2**40, n).astype(np.int64) * np.int64(2**20)
    f = rng.random(n) < density
    got = kernels.seg_scan_plain("sum", t(f), t(x)).numpy()
    want = np.asarray(ps.seg_sum64_pallas(jnp.asarray(f), jnp.asarray(x),
                                          interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,density", [
    pytest.param(0, 0.05, id="0"), pytest.param(2 * B + 101, 0.05, id="2149"),
    (3 * B + 17, 0.0), (3 * B + 17, 1.0)])
def test_seg_sum_f64_plain_matches_pallas(tiny, rng, n, density):
    x = rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))
    f = rng.random(n) < density
    got = kernels.seg_scan_plain("sum", t(f), t(x)).numpy()
    want = np.asarray(ps.seg_sum_f64_pallas(jnp.asarray(f), jnp.asarray(x),
                                            interpret=True))
    atol = np.abs(x).max() * 1e-12 if n else 0
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=atol)


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
@pytest.mark.parametrize("kind", ["min", "max"])
def test_seg_select64_matches_pallas(tiny, rng, dtype, kind):
    """64-bit segmented min/max over order-preserving encodings: NaN is
    greatest, -0.0 and denormals canonicalize, as in the TPU kernel."""
    n = B + 55
    if dtype is np.int64:
        x = rng.integers(-2**60, 2**60, n).astype(np.int64)
    else:
        x = rng.standard_normal(n) * 1e12
        x[rng.random(n) < 0.02] = np.nan
        x[rng.random(n) < 0.02] = -0.0
    f = rng.random(n) < 0.04
    enc = jsort.radix_encode(jnp.asarray(x))
    out = ps.seg_sel64_pallas(kind + "64", jnp.asarray(f), enc,
                              interpret=True)
    want = np.asarray(jsort.radix_decode(out, x.dtype))
    fn = engine.seg_scan_min if kind == "min" else engine.seg_scan_max
    got = fn(t(x), t(f)).numpy()
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("cap,density", [
    (2 * B + 77, 0.9), (4 * B, 0.01), (3 * B, 1.0)])
def test_expand_fill_plain_matches_pallas(tiny, rng, cap, density):
    nsrc = max(1, int(cap * density))
    pos = np.sort(rng.choice(cap, nsrc, replace=False)).astype(np.int32)
    pos = np.concatenate([pos, np.full(7, expand.SENTINEL, np.int32)])
    w1 = rng.integers(1, 2**30, pos.size).astype(np.int32)
    w2 = rng.integers(-2**30, 2**30, pos.size).astype(np.int32)
    want = expand.expand_fill_pallas(jnp.asarray(pos),
                                     [jnp.asarray(w1), jnp.asarray(w2)],
                                     cap, interpret=True)
    got = kernels.expand_fill_plain(t(pos), [t(w1), t(w2)], cap)
    assert kernels.SENTINEL == int(expand.SENTINEL)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_expand_fill_plain_no_source_before_first(tiny):
    pos = np.asarray([B + 5], np.int32)
    w = np.asarray([42], np.int32)
    (want,) = expand.expand_fill_pallas(jnp.asarray(pos), [jnp.asarray(w)],
                                        2 * B, interpret=True)
    (got,) = kernels.expand_fill_plain(t(pos), [t(w)], 2 * B)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors each wrapper is its plain version and launches
    nothing."""
    kernels.reset_launch_counts()
    x = torch.arange(10, dtype=torch.int32)
    f = x % 3 == 0
    assert torch.equal(kernels.scan("sum", x), kernels.scan_plain("sum", x))
    assert torch.equal(kernels.scan("min", x, reverse=True),
                       kernels.scan_plain("min", x, reverse=True))
    assert torch.equal(kernels.seg_scan("carry", f, x),
                       kernels.seg_scan_plain("carry", f, x))
    (a,), c = kernels.compact([x], f)
    assert int(c) == 4 and a[:4].tolist() == [0, 3, 6, 9]
    (e,) = kernels.expand_fill(torch.tensor([2, 5], dtype=torch.int32),
                               [torch.tensor([7, 8], dtype=torch.int32)], 7)
    assert e.tolist() == [0, 0, 7, 7, 7, 8, 8]
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


def test_wrappers_raise_off_the_cpu_without_a_kernel():
    """A tensor that is not on the CPU never takes the plain version: off a
    CUDA device the wrapper raises instead of launching."""
    x = torch.empty(10, dtype=torch.int32, device="meta")
    f = torch.empty(10, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        kernels.scan("sum", x)
    with pytest.raises(ValueError):
        kernels.seg_scan("carry", f, x)
    with pytest.raises(ValueError):
        kernels.compact([x], f)
    with pytest.raises(ValueError):
        kernels.expand_fill(x, [x], 5)
    with pytest.raises(ValueError):   # mixed devices
        kernels.compact([torch.zeros(10, dtype=torch.int32)], f)
    m = torch.empty(10, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        kernels.elementwise_binary("add", m, m)
    with pytest.raises(ValueError):
        kernels.elementwise_compare(m, "lt", 0.0)


def test_h8_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors H8's wrappers are their plain versions (each float
    input flushed, then torch's op; a compare's bool as int8) and launch
    nothing; what H8 cannot read raises on the card's path only."""
    kernels.reset_launch_counts()
    a = torch.tensor([1e-310, -1e-310, 1.5, float("nan")],
                     dtype=torch.float64)
    b = torch.tensor([1e-40, 2.0, -0.0, 1.0], dtype=torch.float32)
    got = kernels.elementwise_binary("mul", a, b)
    assert got.dtype == torch.float64
    assert got[:3].tolist() == [0.0, 0.0, 0.0] and got[3].isnan()
    assert got[:3].signbit().tolist() == [False, True, True]
    stencil = kernels.elementwise_compare(a, "le", 0.0)
    assert stencil.dtype == torch.int8
    assert stencil.tolist() == [1, 1, 0, 0]
    assert kernels.elementwise_compare(
        torch.tensor([0, 1], dtype=torch.int32), "lt", 0.5).tolist() == [1, 0]
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


@pytest.mark.parametrize("library", [_lib.KERNELS, _common.LIBRARY],
                         ids=lambda lib: lib.name)
def test_failed_build_raises(monkeypatch, tmp_path, library):
    """A compiler failure surfaces as a GDFError carrying its output, and
    leaves no library behind: the operators' library and the probes'."""
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_lib, "_nvcc", lambda: "false")
    with pytest.raises(GDFError, match="nvcc failed"):
        library.build()
    assert list(tmp_path.iterdir()) == []


def test_operators_and_probes_build_apart():
    """The operators' library compiles no probe source and binds no probe
    entry point; the probes' compiles and binds only theirs. Both hash the
    headers their sources include, and every source exists."""
    ops, probes = _lib.KERNELS, _common.LIBRARY
    assert _lib.library_path() == ops.path() != probes.path()
    assert not any(p.name.startswith("probe_") for p in ops.sources())
    assert not any(n.startswith("gdf_probe_") for n in ops.signatures)
    compiled = [p for p in probes.sources() if p.suffix == ".cu"]
    assert compiled and all(p.name.startswith("probe_") for p in compiled)
    assert all(n.startswith("gdf_probe_") for n in probes.signatures
               if n != "gdf_cuda_error_string")
    assert {p.name for p in ops.sources() if p.suffix == ".cuh"} == {
        "common.cuh", "lookback.cuh"}
    assert {p.name for p in probes.sources() if p.suffix == ".cuh"} == {
        "common.cuh"}
    every = {p.name for p in _lib.CSRC.iterdir()}
    assert {p.name for p in ops.sources() + probes.sources()} == every



@pytest.mark.parametrize("library", [_lib.KERNELS, _common.LIBRARY],
                         ids=lambda lib: lib.name)
def test_an_error_reads_its_own_library(monkeypatch, library):
    """A failed launch's message comes from the library that returned it:
    a probe's error never loads (or builds) the operators' library, nor an
    operator's the probes'."""
    class Lib:
        @staticmethod
        def gdf_cuda_error_string(err):
            return f"error {err} of {library.name}".encode()

    def refuse():
        raise AssertionError("loaded the other library")
    for lib in (_lib.KERNELS, _common.LIBRARY):
        monkeypatch.setattr(lib, "load",
                            (lambda: Lib) if lib is library else refuse)
    library.check(0, "fine")
    with pytest.raises(GDFError, match=f"what: error 98 of {library.name}"):
        library.check(98, "what")


def test_launch_counts_are_exact_across_threads():
    """8 threads x 10,000 calls of the locked counter lose no count (the
    shards of an in-process mesh launch kernels from one thread each)."""
    import sys
    import threading

    def fake():
        pass
    fake.launches, fake.launches_by_dtype = 0, {}
    calls, threads = 10_000, 8

    def work(i):
        dt = torch.int32 if i % 2 else torch.float64
        for _ in range(calls):
            kernels.count_launch(fake, dt)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert fake.launches == threads * calls
    assert fake.launches_by_dtype == {"int32": threads * calls // 2,
                                      "float64": threads * calls // 2}
    _lib.reset_counts(fake)
    assert fake.launches == 0 and fake.launches_by_dtype == {}
