"""The cost probes' plain versions (libgdf_tpu_torch/probes/) against the
Pallas probes under benchmarks/, run in TPU interpret mode on the CPU.

Each probe file is loaded by its path and run as it is: its jitted
function (tile_sort, the gather builders), its own pallas_call with the
roll kernels (`REPS` patched to 24), or its capability function with the
pallas_call's output recorded on the way (`_Record`). The port's plain
version gets the same numpy inputs and must give the same values exactly:
every output is an integer or a gathered float (NaN equal to NaN). The
kernels themselves run only on the card (tests/test_torch_cuda.py).
"""
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from libgdf_tpu_torch import probes
from libgdf_tpu_torch.probes import caps, gather, roll, tilesort

BENCH = Path(__file__).resolve().parents[1] / "benchmarks"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_bench_{name}",
                                                  BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def probe_tilesort():
    return _load("probe_tilesort")


@pytest.fixture
def probe_gather():
    return _load("probe_pallas_gather")     # a fresh generator per test


@pytest.fixture(scope="module")
def probe_roll():
    return _load("probe_roll")


@pytest.fixture(scope="module")
def probe_caps():
    return _load("probe_pallas_caps")


def _equal(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- P-1 tile_sort ------------------------------------------------------------

def _tile_sort_both(probe, key, pay):
    with pltpu.force_tpu_interpret_mode():
        ko, po = probe.tile_sort(jax.numpy.asarray(key),
                                 jax.numpy.asarray(pay))
    got = tilesort.tile_sort_plain(torch.as_tensor(key), torch.as_tensor(pay))
    _equal(got[0], ko)
    _equal(got[1], po)
    return got


def test_tile_sort_matches_probe_on_its_input(probe_tilesort):
    """One 65,536-element block of the probe's own input (keys drawn as its
    main draws them, an iota payload)."""
    rng = np.random.default_rng(0)
    key = rng.integers(0, 2 ** 31 - 1, tilesort.DEFAULT_N).astype(
        np.int32)[:tilesort.BLOCK]
    pay = np.arange(tilesort.BLOCK, dtype=np.int32)
    ko, po = _tile_sort_both(probe_tilesort, key, pay)
    np.testing.assert_array_equal(ko.numpy(), np.sort(key))
    np.testing.assert_array_equal(key[po.numpy()], ko.numpy())


def test_tile_sort_ties_signed(probe_tilesort):
    """Keys in [-4, 4) and a permuted, partly negative payload: ties of key
    come out in signed payload order."""
    rng = np.random.default_rng(7)
    key = rng.integers(-4, 4, tilesort.BLOCK).astype(np.int32)
    pay = (rng.permutation(tilesort.BLOCK) - 20_000).astype(np.int32)
    ko, po = _tile_sort_both(probe_tilesort, key, pay)
    order = np.lexsort((pay, key))
    np.testing.assert_array_equal(ko.numpy(), key[order])
    np.testing.assert_array_equal(po.numpy(), pay[order])


def test_tile_sort_stage_counts(probe_tilesort):
    """2^16-element blocks: 136 stages a block and, for a 2^24-element
    sort, 264 in-block stages and 36 cross-block passes. The probe's
    docstring and estimate (153 / 272, 28 passes) are 2^17's counts."""
    assert tilesort.BLOCK == probe_tilesort.BLOCK == 2 ** 16
    assert tilesort.K == probe_tilesort.K == 16
    assert tilesort.stage_counts(tilesort.BLOCK, 2 ** 24) == (136, 264, 36)
    assert tilesort.stage_counts(2 ** 17, 2 ** 24) == (153, 272, 28)
    assert tilesort.stage_counts(tilesort.BLOCK, tilesort.BLOCK) == \
        (136, 136, 0)


def test_tile_sort_rejects_ragged_n():
    x = torch.zeros(tilesort.BLOCK + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 65536"):
        tilesort.tile_sort(x, x)
    with pytest.raises(TypeError):
        tilesort.tile_sort(x.long(), x.long())


# -- P-2 .. P-5 the gathers ---------------------------------------------------

BUILDERS = {"lane": ("build_lane_gather", gather.lane_gather_plain),
            "sublane": ("build_sublane_gather", gather.sublane_gather_plain),
            "flat": ("build_flat_take", gather.flat_take_plain),
            "2d": ("build_take_2d_decomp", gather.flat_take_plain)}


@pytest.mark.parametrize("case", list(BUILDERS))
def test_gather_matches_probe(probe_gather, case):
    builder, plain = BUILDERS[case]
    with pltpu.force_tpu_interpret_mode():
        fn, args, check = getattr(probe_gather, builder)()
        want = np.asarray(fn(*args))
    assert check(want)
    _equal(plain(*[torch.as_tensor(np.asarray(a)) for a in args]), want)


@pytest.mark.parametrize("case", ["lane", "sublane", "flat"])
def test_gather_out_of_range_matches_probe(probe_gather, case):
    """Indices in [-size, 0) count from the end; indices outside
    [-size, size) give NaN, as the probe's jnp.take does in interpret
    mode. (The 2-D builder's function gathers its own indices whatever
    it is given, probe_pallas_gather.py:142-149.)"""
    builder, plain = BUILDERS[case]
    with pltpu.force_tpu_interpret_mode():
        fn, (x, idx), _ = getattr(probe_gather, builder)()
        size = x.shape[1] if case == "lane" else \
            x.shape[0] if case == "sublane" else x.size
        bad = np.asarray(idx).copy()
        bad[0, :7] = [-1, -size, size, -size - 1, 2 ** 31 - 1, -2 ** 31, 0]
        want = np.asarray(fn(x, jax.numpy.asarray(bad)))
    got = plain(torch.as_tensor(np.asarray(x)), torch.as_tensor(bad))
    _equal(got, want)
    assert np.isnan(got[0, 2:6].numpy()).all()


def test_gather_int32_fill():
    """At int32 the fill is INT32_MIN, as jnp's."""
    x = torch.arange(2 * 128, dtype=torch.int32).reshape(2, 128)
    idx = torch.zeros((2, 128), dtype=torch.int32)
    idx[0, :3] = torch.tensor([128, -1, -129])
    got = gather.lane_gather_plain(x, idx)
    want = jax.numpy.take_along_axis(jax.numpy.asarray(x.numpy()),
                                     jax.numpy.asarray(idx.numpy()), axis=1)
    _equal(got, want)
    assert got[0, :3].tolist() == [-2 ** 31, 127, -2 ** 31]


def test_gather_inputs_are_the_probes(probe_gather):
    """gather.probe_inputs draws what the probe's builders draw."""
    mine = gather.probe_inputs()
    for (_, kind, x, idx), builder in zip(mine, BUILDERS.values()):
        _, args, _ = getattr(probe_gather, builder[0])()
        np.testing.assert_array_equal(x, np.asarray(args[0]))
        np.testing.assert_array_equal(idx, np.asarray(args[1]))


# -- P-6 / P-7 the rolls ------------------------------------------------------

class _Stop(Exception):
    pass


class _FirstCall:
    """Stands for `jax` in a probe module: jax.jit(f) records the first
    output of f jitted (on `args(probe's args)` where given) and raises
    _Stop, so the probe's timing loop never runs."""

    def __init__(self, args=None):
        self.args = args
        self.out = None

    def jit(self, f):
        jitted = jax.jit(f)

        def first(*args):
            if self.args is not None:
                args = self.args(args)
            self.out = np.asarray(jitted(*args))
            raise _Stop
        return first

    def __getattr__(self, name):
        return getattr(jax, name)


def _run_roll(probe, monkeypatch, kind, reps, args=None):
    monkeypatch.setattr(probe, "REPS", reps)
    rec = _FirstCall(args)
    monkeypatch.setattr(probe, "jax", rec)
    with pltpu.force_tpu_interpret_mode(), pytest.raises(_Stop):
        probe.run(kind)
    return rec.out


@pytest.mark.parametrize("kind", ["static", "dynamic"])
def test_roll_matches_probe(probe_roll, monkeypatch, kind):
    reps = 24
    want = _run_roll(probe_roll, monkeypatch, kind, reps)
    x, s = roll.probe_inputs()
    xt = torch.as_tensor(x)
    if kind == "static":
        got = roll.roll_static_plain(xt, reps)
        shifts = roll.static_shifts(reps)
    else:
        got = roll.roll_dynamic_plain(torch.as_tensor(s), xt, reps)
        shifts = roll.dynamic_shifts(s, reps)
    _equal(got, want)
    np.testing.assert_array_equal(want, roll.numpy_roll(x, shifts))


def test_roll_direction_and_wide_shifts(probe_roll, monkeypatch):
    """The dynamic probe at shifts 0, 32, 64, 96, 127, 1, 31, 33: pltpu.roll
    has np.roll's direction, out[:, j] = x[:, (j - s) mod 128]."""
    s = np.array([0, 32, 64, 96, 127, 1, 31, 33], np.int32)
    want = _run_roll(probe_roll, monkeypatch, "dynamic", 8,
                     lambda args: (jax.numpy.asarray(s), args[1]))
    x, _ = roll.probe_inputs()
    got = roll.roll_dynamic_plain(torch.as_tensor(s), torch.as_tensor(x), 8)
    _equal(got, want)
    one = roll.roll_plain(torch.as_tensor(x), [5])
    assert one[0, 5] == x[0, 0] + 1 and one[0, 0] == x[0, 123] + 1


def test_roll_rejects_bad_shapes():
    with pytest.raises(TypeError):
        roll.roll_static(torch.zeros((4, 64), dtype=torch.int32))
    with pytest.raises(TypeError):
        roll.roll_dynamic(torch.zeros(7, dtype=torch.int32),
                          torch.zeros((4, 128), dtype=torch.int32))


# -- P-8 .. P-14 the capability probes ----------------------------------------

class _Record:
    """Stands for `pl` in probe_pallas_caps: pl.pallas_call(...) runs the
    real call, on `inputs` in place of the probe's own where given, and
    records its output."""

    def __init__(self, pl, inputs=None):
        self._pl = pl
        self.inputs = inputs
        self.out = None

    def pallas_call(self, *a, **kw):
        call = self._pl.pallas_call(*a, **kw)

        def run(*args):
            if self.inputs is not None:
                args = [jax.numpy.asarray(v) for v in self.inputs]
            out = call(*args)
            self.out = np.asarray(out)
            return out
        return run

    def __getattr__(self, name):
        return getattr(self._pl, name)


def _run_cap(probe, monkeypatch, capsys, name, inputs=None):
    rec = _Record(probe.pl, inputs)
    monkeypatch.setattr(probe, "pl", rec)
    with pltpu.force_tpu_interpret_mode():
        getattr(probe, name)()
    return rec.out, capsys.readouterr().out


CAP_PLAIN = {"p1": caps.cap_dyn_store_plain, "p2": caps.cap_cumsum2d_plain,
             "p3": caps.cap_onehot_compact_plain,
             "p4": caps.cap_bulk_copy_plain,
             "p5": gather.lane_gather_plain, "p7": caps.cap_dyn_loop_plain}


def _cap_case(name, inputs):
    rows = caps.PROBES[name][3]
    return CAP_PLAIN[name](*[torch.as_tensor(a) for a in inputs])[:rows], rows


@pytest.mark.parametrize("name", list(CAP_PLAIN))
def test_cap_matches_probe(probe_caps, monkeypatch, capsys, name):
    """On the probe's inputs; p4's rows past 18 are never written."""
    want, printed = _run_cap(probe_caps, monkeypatch, capsys, name)
    assert printed.startswith(f"OK   {caps.PROBES[name][0]}"), printed
    got, rows = _cap_case(name, caps.probe_inputs()[name])
    _equal(got, want[:rows])
    assert caps.probe_check(name, got.numpy())


def _random_cap_inputs(name, rng):
    ints = lambda *shape: rng.integers(-2 ** 31, 2 ** 31, shape).astype(
        np.int32)
    if name == "p1":
        x = ints(16, 128)
        x[0, 0] = 5                   # the slice lands at row 8
        return (x,)
    if name == "p2":
        return (ints(64, 128),)
    if name == "p3":
        return (ints(2, 128),
                (rng.random((2, 128)) < 0.6).astype(np.int32))
    if name == "p4":
        return (ints(24, 128),)
    if name == "p5":
        return (ints(8, 128), rng.integers(0, 128, (8, 128)).astype(np.int32))
    x = ints(8, 128)
    x[0, 0] = -3                      # (-3 & 7) + 2 = 7 trips
    return (x,)


@pytest.mark.parametrize("name", list(CAP_PLAIN))
def test_cap_matches_probe_on_random_inputs(probe_caps, monkeypatch, capsys,
                                            name):
    """The probe's kernels on full-range int32 inputs in place of its own
    (its own check then need not hold): the plain versions agree."""
    inputs = _random_cap_inputs(name, np.random.default_rng(3))
    want, _ = _run_cap(probe_caps, monkeypatch, capsys, name, inputs)
    got, rows = _cap_case(name, inputs)
    _equal(got, want[:rows])


@pytest.mark.parametrize("x00", [-3, 21])
def test_cap_dyn_store_at_the_scratch_edges(probe_caps, monkeypatch, capsys,
                                            x00):
    """Row offsets 0 and 24, the first and last whose 8 rows fit."""
    x = np.arange(16 * 128, dtype=np.int32).reshape(16, 128)
    x[0, 0] = x00
    want, _ = _run_cap(probe_caps, monkeypatch, capsys, "p1", (x,))
    _equal(caps.cap_dyn_store_plain(torch.as_tensor(x)), want)


@pytest.mark.parametrize("x00", [-4, 22, 2 ** 31 - 1])
def test_cap_dyn_store_outside_the_scratch_raises(probe_caps, monkeypatch,
                                                  capsys, x00):
    """An offset whose rows leave the scratch is an error in the probe (in
    interpret mode) and in the port."""
    x = np.zeros((16, 128), np.int32)
    x[0, 0] = x00
    _, printed = _run_cap(probe_caps, monkeypatch, capsys, "p1", (x,))
    assert printed.startswith("FAIL dyn_vmem_store_1d"), printed
    with pytest.raises(ValueError, match="outside"):
        caps.cap_dyn_store_plain(torch.as_tensor(x))


def test_cap_carry_and_the_broken_probe(probe_caps, capsys):
    """p6 still raises at its own call (no scratch for its SMEM
    accumulator), so it is held to its assertion, 4 x 8 x 128 = 4096; a
    repair of the probe would show here."""
    with pltpu.force_tpu_interpret_mode():
        probe_caps.p6()
    printed = capsys.readouterr().out
    assert printed.startswith("FAIL smem_carry_across_grid: TypeError")
    assert "acc_ref" in printed
    x = torch.as_tensor(caps.probe_inputs()["p6"][0])
    assert caps.cap_carry_plain(x).tolist() == [[4096]]
    big = torch.full((16, 128), 2 ** 30, dtype=torch.int32)
    assert caps.cap_carry_plain(big).tolist() == [[0]]    # wraps as int32


# -- the wrappers, the counts, the mains, the imports -------------------------

def _cpu_calls():
    rng = np.random.default_rng(5)
    i32 = lambda *shape: torch.as_tensor(
        rng.integers(-1000, 1000, shape).astype(np.int32))
    key = i32(tilesort.BLOCK)
    x = torch.as_tensor(rng.standard_normal((16, 128)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(-200, 200, (16, 128)).astype(np.int32))
    s = torch.tensor([3, -1, 0, 127, 128, 40, 2, 9], dtype=torch.int32)
    keep = (i32(2, 128) > 0).int()
    stored = i32(16, 128)
    stored[0, 0] = 2                  # rows [5, 13) of the scratch
    return [
        (tilesort.tile_sort, tilesort.tile_sort_plain, (key, key)),
        (gather.lane_gather, gather.lane_gather_plain, (x, idx)),
        (gather.sublane_gather, gather.sublane_gather_plain, (x, idx)),
        (gather.flat_take, gather.flat_take_plain, (x, idx)),
        (roll.roll_static, roll.roll_static_plain, (i32(4, 128), 9)),
        (roll.roll_dynamic, roll.roll_dynamic_plain, (s, i32(4, 128), 9)),
        (caps.cap_dyn_store, caps.cap_dyn_store_plain, (stored,)),
        (caps.cap_cumsum2d, caps.cap_cumsum2d_plain, (i32(64, 128),)),
        (caps.cap_onehot_compact, caps.cap_onehot_compact_plain,
         (i32(2, 128), keep)),
        (caps.cap_bulk_copy, caps.cap_bulk_copy_plain, (i32(24, 128),)),
        (caps.cap_carry, caps.cap_carry_plain, (i32(32, 128),)),
        (caps.cap_dyn_loop, caps.cap_dyn_loop_plain, (i32(8, 128),)),
    ]


def test_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors each wrapper is its plain version and launches
    nothing."""
    probes.reset_launch_counts()
    calls = _cpu_calls()
    assert {fn.__name__ for fn, _, _ in calls} == set(probes.wrappers())
    for fn, plain, args in calls:
        got, want = fn(*args), plain(*args)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert probes.launch_counts() == dict.fromkeys(probes.wrappers(), 0)


def test_wrappers_raise_off_the_cpu_without_a_kernel():
    """A tensor that is not on the CPU never takes the plain version."""
    for fn, _, args in _cpu_calls():
        meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
                for a in args]
        with pytest.raises(ValueError, match="CUDA"):
            fn(*meta)


def test_onehot_compact_plain_by_tile():
    """Each 256-element tile is compacted on its own, the tail zero."""
    x = torch.arange(512, dtype=torch.int32) + 1
    keep = (x % 2 == 0).int()
    got = caps.cap_onehot_compact_plain(x, keep)
    assert got[:128].tolist() == list(range(2, 257, 2))
    assert got[256:384].tolist() == list(range(258, 513, 2))
    assert not got[128:256].any() and not got[384:].any()


def test_mains_on_the_cpu(capsys):
    assert tilesort.main([str(tilesort.BLOCK), "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out)
    assert list(line) == ["n", "build_s", "tile_sort_rows_per_s",
                          "tile_sort_ms", "full_sort_est_rows_per_s",
                          "torch_sort_2op_rows_per_s", "torch_sort_ms",
                          "verdict"]
    assert line["n"] == tilesort.BLOCK and line["verdict"] in ("keep",
                                                               "kill")
    assert gather.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4 and all("ok=True" in ln for ln in lines)
    assert caps.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in lines] == [
        ["OK", p[0]] for p in caps.PROBES.values()]


def test_mains_need_cuda_unless_asked(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (tilesort, gather, roll, caps):
        assert mod.main([]) == 1
    assert capsys.readouterr().out == ""


def test_probes_import_without_jax():
    code = ("import sys; from libgdf_tpu_torch import probes; "
            "from libgdf_tpu_torch.probes import caps, gather, roll, "
            "tilesort; probes.launch_counts(); "
            "print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "False"
