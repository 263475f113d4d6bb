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

import libgdf_tpu_torch
from libgdf_tpu_torch import probes
from libgdf_tpu_torch.probes import caps, gather, roll, tilesort, turns

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


def _network():
    return [(k, j) for k in range(1, tilesort.K + 1)
            for j in range(k - 1, -1, -1)]


def test_tile_sort_schedule_covers_the_network():
    """The kernel's schedule runs each of the 136 stages once, in network
    order: registers for every stage inside a 16K tile (each at a register
    bit of its layout), the cluster for the three across tiles, and 29
    shared-memory round trips (28 changes of layout and the second
    exchange of size 2^16)."""
    phases = tilesort.schedule()
    stages = [st for ph in phases for st in ph.stages]
    assert stages == _network() and len(stages) == 136
    assert [ph.stages for ph in phases if ph.where == "cluster"] == \
        [[(15, 14)], [(16, 15)], [(16, 14)]]
    for ph in phases:
        assert ph.where in ("registers", "cluster")
        assert len(set(ph.layout)) == tilesort.REG_LOG
        for _, j in ph.stages:
            assert (j in ph.layout) == (ph.where == "registers")
    changes = sum(a.layout != b.layout for a, b in zip(phases, phases[1:]))
    repeats = sum(a.where == b.where == "cluster"
                  for a, b in zip(phases, phases[1:]))
    assert (changes, changes + repeats) == (28, 29)


def _run_schedule(words):
    """The schedule on (blocks, 65536) int64 packed words, as the kernel
    runs it: 4 tiles a block, a (512, 32) register file a tile in each
    phase's layout; a register stage is one direction a thread (bit k of
    its index) except for sizes 2 .. 16 in the first layout."""
    w = words.reshape(words.shape[0], 4, 1 << tilesort.TILE_LOG).copy()
    rank = np.arange(4)[None, :, None, None]
    for n, ph in enumerate(tilesort.schedule()):
        idx = tilesort.layout_index(ph.layout)
        regs = w[:, :, idx]                       # (blocks, 4, 512, 32)
        block_idx = rank << tilesort.TILE_LOG | idx
        for k, j in ph.stages:
            if ph.where == "cluster":
                b = j - tilesort.TILE_LOG
                peer = regs[:, np.arange(4) ^ (1 << b)]
                low = (rank >> b & 1) == 0
                asc = True if k == tilesort.K else (rank >> 1 & 1) == 0
                regs = np.where((peer < regs) == (low == asc), peer, regs)
                continue
            q = ph.layout.index(j)
            lo = [e for e in range(32) if not e >> q & 1]
            hi = [e | 1 << q for e in lo]
            desc = (block_idx[..., lo] >> k & 1).astype(bool) \
                if k < tilesort.K else np.zeros((1, 4) + idx[:, lo].shape,
                                                dtype=bool)
            if not (n == 0 and k < tilesort.REG_LOG):
                assert (desc == desc[..., :1]).all()   # one per thread
            a, b = regs[..., lo], regs[..., hi]
            swap = (b < a) != desc
            regs[..., lo] = np.where(swap, b, a)
            regs[..., hi] = np.where(swap, a, b)
        w[:, :, idx] = regs
    return w.reshape(words.shape)


def _i32_extremes(rng, n, values):
    return rng.choice(np.array(values, dtype=np.int32), n)


@pytest.mark.parametrize("case", ["random", "equal", "extremes"])
def test_tile_sort_schedule_in_numpy(case):
    """The schedule run in numpy equals tile_sort_plain on random blocks,
    on blocks of equal keys and on keys and payloads at INT32_MIN /
    INT32_MAX."""
    rng = np.random.default_rng(21)
    n = 2 * tilesort.BLOCK
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    if case == "random":
        key = rng.integers(lo, hi + 1, n, dtype=np.int64).astype(np.int32)
        pay = rng.permutation(n).astype(np.int32)
    elif case == "equal":
        key = np.full(n, -5, np.int32)
        pay = (rng.permutation(n) - n // 2).astype(np.int32)
    else:
        key = _i32_extremes(rng, n, [lo, hi, -1, 0])
        pay = _i32_extremes(rng, n, [lo, hi, 0])
    kt, pt = torch.as_tensor(key), torch.as_tensor(pay)
    words = tilesort.pack(kt, pt).numpy().reshape(-1, tilesort.BLOCK)
    got = tilesort.unpack(torch.as_tensor(_run_schedule(words)).reshape(-1))
    want = tilesort.tile_sort_plain(kt, pt)
    _equal(got[0], want[0])
    _equal(got[1], want[1])


def test_tile_sort_layouts_have_no_bank_conflicts():
    """In every layout of the schedule a warp's 32 loads or stores of one
    register (8 bytes) fall on 16 distinct bank pairs, two each; the cross
    layout's 16-byte loads of a register pair on 8 distinct bank quads,
    four each: the fewest wavefronts either width allows."""
    for layout in {ph.layout for ph in tilesort.schedule()}:
        slots = tilesort.slot(tilesort.layout_index(layout))
        by_warp = slots.reshape(-1, 32, 32)         # warp, lane, register
        for e in range(32):
            for warp in by_warp[:, :, e]:
                assert (np.bincount(warp % 16, minlength=16) == 2).all()
        if layout == tilesort.CROSS:
            pairs = by_warp[:, :, 0::2] >> 1
            assert (by_warp[:, :, 0::2] >> 1 == by_warp[:, :, 1::2] >> 1).all()
            for warp in pairs.transpose(0, 2, 1).reshape(-1, 32):
                assert (np.bincount(warp % 8, minlength=8) == 4).all()


def test_tile_sort_transposes_stay_within_their_sync_groups():
    """Between windows A and B (index bits B .. B+4 in the register) the
    kernel syncs only the 2^max(A, B) threads that share thread bits
    max(A, B) .. 8 (`sync_group`): each such group holds the same words
    before and after, so no other thread's words pass through it. Every
    layout change inside the tile is such a pair; the others (window 9,
    the cross layout) sync the CTA."""
    phases = tilesort.schedule()
    windows = {tilesort.window(b): b for b in range(10)}
    seen = set()
    for a, b in zip(phases, phases[1:]):
        if a.layout == b.layout or a.layout not in windows or \
                b.layout not in windows:
            continue
        m = max(windows[a.layout], windows[b.layout])
        if m == 9:
            continue
        seen.add(m)
        ia = tilesort.layout_index(a.layout).reshape(-1, 2 ** m * 32)
        ib = tilesort.layout_index(b.layout).reshape(-1, 2 ** m * 32)
        assert (np.sort(ia, 1) == np.sort(ib, 1)).all()
    assert seen == {1, 2, 3, 4, 5, 6, 7, 8}


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


_S = gather.TAKE_SLAB_WORDS


@pytest.mark.parametrize("n", [1, 3, 1000, _S - 1, _S, _S + 1, 1 << 16,
                               2 * _S - 1, 2 * _S, 2 * _S + 1, 4 * _S + 1,
                               8 * _S, 8 * _S + 1, 10 ** 7])
def test_take_plan_routes_by_size(n):
    """The slab each block holds is a multiple of 4 words within the
    limit: the whole table where it fits, else the limit (the rest goes
    through L1 / L2)."""
    s = gather.take_plan(n)
    assert s % 4 == 0 and s <= _S
    assert s == _S if n > _S else n <= s < n + 4


def test_take_plan_of_the_probes_tables():
    assert gather.take_plan(1 << 16) == _S
    assert gather.take_plan(512 * 128) == _S
    assert gather.take_plan(_S) == _S
    assert gather.take_plan(1000) == 1000
    assert gather.take_plan(1) == 4


@pytest.mark.parametrize("n_idx, blocks_per_sm, sms, want", [
    (81_920 * 128, 1, 132, 132),        # persistent: the blocks that fit
    (8192 * 128, 1, 132, 128),          # the probe's 1M indices
    (13, 1, 132, 1),                    # one block
    (81_920 * 128, 2, 132, 264),        # a small slab: two blocks an SM
    (5 * 8192, 2, 132, 5),              # never more than the indices fill
    (8192 + 1, 1, 132, 2),
    (0, 1, 132, 1),                     # at least one
    (81_920 * 128, 1, 114, 114)])       # another card's SMs
def test_take_grid(n_idx, blocks_per_sm, sms, want):
    assert gather.take_grid(n_idx, blocks_per_sm, sms) == want


@pytest.mark.parametrize("rows", [1, 13, 1024, 8191, 81_920, 10 ** 6])
@pytest.mark.parametrize("table_rows, blocks_per_sm", [
    (1, 2), (31, 2), (1024, 1), (1792, 1)])
def test_sublane_plan(rows, table_rows, blocks_per_sm):
    """A multiple of 4 blocks, never more than fit at once nor more than
    the (slab, chunk) pairs; chunks of whole warps' rows covering every
    row; chunks as large as keeps every block busy."""
    sms = 132
    chunk, grid = gather.sublane_plan(rows, sms, blocks_per_sm)
    k = chunk // gather.SUB_WARPS
    chunks = -(-rows // chunk)
    assert chunk % gather.SUB_WARPS == 0
    assert 1 <= k <= gather.SUB_ROWS_IN_FLIGHT and k & (k - 1) == 0
    assert grid % 4 == 0 and 4 <= grid <= sms * blocks_per_sm
    assert grid == min(sms * blocks_per_sm // 4 * 4, 4 * chunks)
    if k > 1:
        assert 4 * chunks >= sms * blocks_per_sm // 4 * 4
    if k < gather.SUB_ROWS_IN_FLIGHT:
        assert 4 * -(-rows // (2 * chunk)) < sms * blocks_per_sm // 4 * 4


def test_sublane_plan_at_the_probes_shapes():
    """At the probe's 1024 rows every SM but 4 gets a chunk (a block per
    slab and 256-row chunk would use 16); at 81,920 rows each slab is
    staged 33 times, not 320."""
    assert gather.sublane_plan(1024, 132, 1) == (32, 128)
    assert gather.sublane_plan(81_920, 132, 1) == (256, 132)


@pytest.mark.parametrize("n, slab", [(1000, 1000), (1 << 16, _S),
                                     (2 * _S, _S), (2 * _S + 1, _S)])
def test_flat_take_launches_the_planned_route(monkeypatch, n, slab):
    """On a CUDA tensor the wrapper asks the occupancy of take_plan's slab
    and launches the kernel once with it and take_grid's blocks."""
    calls = []
    monkeypatch.setattr(gather._common, "on_cpu", lambda *t: False)
    monkeypatch.setattr(gather._lib, "require_cuda",
                        lambda what, *t: torch.device("cuda", 0))
    monkeypatch.setattr(gather, "_sms", lambda dev: 132)
    monkeypatch.setattr(gather, "_units",
                        lambda index, entry, *args: calls.append(
                            (entry, args)) or 2)
    monkeypatch.setattr(gather._common, "launch",
                        lambda *args: calls.append(args))
    table = torch.zeros(n)
    idx = torch.zeros(100_000, dtype=torch.int32)
    gather.flat_take(table, idx)
    (entry, args), launch = calls
    assert entry == "gdf_probe_flat_take_occupancy" and args == (slab,)
    assert launch[2] == "gdf_probe_flat_take"
    assert launch[-2:] == (slab, gather.take_grid(100_000, 2, 132))


def test_sublane_gather_launches_its_plan(monkeypatch):
    calls = []
    monkeypatch.setattr(gather._common, "on_cpu", lambda *t: False)
    monkeypatch.setattr(gather._lib, "require_cuda",
                        lambda what, *t: torch.device("cuda", 0))
    monkeypatch.setattr(gather, "_sms", lambda dev: 132)
    monkeypatch.setattr(gather, "_units",
                        lambda index, entry, *args: calls.append(
                            (entry, args)) or 1)
    monkeypatch.setattr(gather._common, "launch",
                        lambda *args: calls.append(args))
    gather.sublane_gather(torch.zeros((1024, 128)),
                          torch.zeros((1024, 128), dtype=torch.int32))
    (entry, args), launch = calls
    assert entry == "gdf_probe_sublane_occupancy" and args == (1024,)
    assert launch[2] == "gdf_probe_sublane_gather"
    assert launch[-2:] == (32, 128)


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


def lane_model(s):
    """csrc/probe_roll.cu's rotation by s in numpy: lane l holds elements
    4l .. 4l+3 of its row; for s mod 128 = 4q + r, output register k takes
    register (k - r) & 3 of lane (l - q - [k < r]) & 31. Returns the source
    register of each k (one for every lane) and the (32, 4) source lanes."""
    s %= roll.LANES
    q, r = s >> 2, s & 3
    k = np.arange(4)
    lane = np.arange(32)[:, None]
    return (k - r) & 3, (lane - q - (k < r)) & 31


def _shuffle(regs, src_reg, src_lane):
    """regs (32, 4); output register k of lane l = regs[src_lane[l, k],
    src_reg[k]]: one shuffle per output register."""
    return np.stack([regs[src_lane[:, k], src_reg[k]] for k in range(4)], 1)


@pytest.mark.parametrize("first", range(-256, 256, 32))
def test_lane_model_is_np_roll(first):
    """One rotation by every s in [first, first + 32) moves each element
    where np.roll does, and each output register reads one source
    register, the same on every lane (no select after the shuffle)."""
    row = np.random.default_rng(first + 256).integers(
        -2 ** 31, 2 ** 31, roll.LANES).astype(np.int32)
    regs = row.reshape(32, 4)
    for s in range(first, first + 32):
        src_reg, src_lane = lane_model(s)
        got = _shuffle(regs, src_reg, src_lane).reshape(-1)
        np.testing.assert_array_equal(got, np.roll(row, s), err_msg=str(s))


def renamed_model(rows, shifts, reps):
    """roll_dynamic_rows in numpy, its loop included: whole groups of the
    8 shifts, then the reps % 8 tail. Registers are renamed: logical
    register k lives in physical register (k + c) & 3, where c is c0 - pre
    (c0 the offset at the group's start, pre = r_0 + .. + r_u after shift
    u); physical register j holds logical (j - c) & 3, which takes its
    source from lane hi where that is below r. Each shift keeps that test
    for c0 = 0 as a 4-bit mask rotated by -pre, doubled (`wrap`), so at
    offset c0 it is bit j of (wrap << c0) >> 4. Every element gets + 1 a
    rotation; the store undoes the renaming."""
    out = np.empty_like(rows)
    lane = np.arange(32)
    plan, pre = [], 0
    for s in shifts:
        s = int(s) % roll.LANES
        r = s & 3
        pre += r
        m, k = (1 << r) - 1, -pre & 3
        rot = ((m << k) | (m >> (4 - k))) & 15
        plan.append(((lane - (s >> 2)) & 31, (lane - (s >> 2) - 1) & 31,
                     rot * 0x11, pre))
    total = pre & 3
    for i, row in enumerate(rows):
        regs = row.reshape(32, 4).copy()

        def rotate(u, c0):
            lo, hi, wrap, _ = plan[u]
            m = (wrap << c0) >> 4
            return np.stack([regs[hi if (m >> j) & 1 else lo, j]
                             for j in range(4)], 1) + np.int32(1)
        c0 = 0
        for _ in range(reps // roll.SHIFTS):
            for u in range(roll.SHIFTS):
                regs = rotate(u, c0)
            c0 = (c0 - total) & 3
        tail = reps % roll.SHIFTS
        for u in range(tail):
            regs = rotate(u, c0)
        c = (c0 - plan[tail - 1][3]) & 3 if tail else c0
        out[i] = regs[:, (np.arange(4) + c) & 3].reshape(-1)
    return out


@pytest.mark.parametrize("shifts", [
    [1, 2, 3, 4, 5, 6, 7, 8], [0, 1, 2, 3, 124, 125, 126, 127],
    [4, 8, 32, 64, 96, 128, 256, 12], [-1, -2, -3, -4, -127, -128, -129,
                                       -300],
    [5] * 8, [2 ** 31 - 1, -2 ** 31, 131, 255, 383, 1000, 3, 2]])
@pytest.mark.parametrize("reps", [0, 1, 7, 8, 9, 15, 16, 25])
def test_renamed_model_is_np_roll(shifts, reps):
    """The dynamic kernel's renamed registers and its loop over groups of
    8 and a tail give np.roll step by step."""
    rows = np.random.default_rng(reps).integers(
        -2 ** 31, 2 ** 31, (3, roll.LANES)).astype(np.int32)
    want = roll.numpy_roll(rows, roll.dynamic_shifts(shifts, reps))
    np.testing.assert_array_equal(renamed_model(rows, shifts, reps), want)


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


@pytest.mark.parametrize("steps", [1, 2, 3, 4, 7, 1000])
def test_bulk_copy_closed_form(steps):
    """The closed form the P-11 kernel computes (each written row from the
    last step that writes it) is the probe's sequence of overwriting
    steps."""
    x = torch.as_tensor(np.random.default_rng(steps).integers(
        -2 ** 31, 2 ** 31, (8 * steps, 128)).astype(np.int32))
    r = caps.bulk_rows(steps)
    src = caps.bulk_sources(steps)
    assert src.shape == (r,) and src.max() < 8 * steps
    _equal(caps.cap_bulk_copy_plain(x)[:r],
           (x[torch.as_tensor(src)].long() + 1000).to(torch.int32))


@pytest.mark.parametrize("rows", [8, 16, 32])
@pytest.mark.parametrize("x00", [-3, 0, 5, 21])
def test_dyn_store_window(rows, x00):
    """The rows the P-8 kernel assigns: x row r - start inside the 8-row
    window at start = x[0, 0] + 3, zeros elsewhere, cut at `rows`."""
    x = torch.arange(rows * 128, dtype=torch.int32).view(rows, 128) + 1
    x[0, 0] = x00
    src = torch.as_tensor(caps.store_window(x00, rows))
    want = torch.where((src >= 0)[:, None], x[src.clamp(min=0)],
                       torch.zeros_like(x))
    _equal(caps.cap_dyn_store_plain(x), want)


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


def _warp_compact(x, keep, stale):
    """P-10's kernel in numpy, lane by lane: lane l of a tile's warp holds
    elements 8l .. 8l+7, counts its kept ones, takes its first destination
    from a 5-step shift-up scan of the counts, writes its kept values into
    the warp's staging row (holding `stale`, a previous tile's words) and
    reads back its 8 slots, zero at or past the warp's total."""
    lanes = x.reshape(-1, 32, 8)
    kept = keep.reshape(-1, 32, 8) != 0
    count = kept.sum(2)
    inc = count.copy()
    for d in (1, 2, 4, 8, 16):
        up = np.zeros_like(inc)
        up[:, d:] = inc[:, :-d]
        inc = inc + up                    # lanes below d add nothing
    total = inc[:, 31:]
    row = np.array(stale, dtype=np.int32).reshape(-1, 256).copy()
    for tile in range(lanes.shape[0]):
        for lane in range(32):
            dest = inc[tile, lane] - count[tile, lane]
            for i in range(8):
                if kept[tile, lane, i]:
                    row[tile, dest] = lanes[tile, lane, i]
                    dest += 1
    return np.where(np.arange(256) >= total, 0, row).reshape(x.shape)


@pytest.mark.parametrize("mask", ["none", "all", "first", "last",
                                  "alternating", "random"])
def test_onehot_compact_lane_destinations(mask):
    """P-10's per-lane destinations, on the edge masks of each tile."""
    rng = np.random.default_rng(13)
    tiles = 3
    x = rng.integers(-2 ** 31, 2 ** 31, tiles * 256).astype(np.int32)
    pos = np.arange(tiles * 256) % 256
    keep = {"none": pos < 0, "all": pos >= 0, "first": pos == 0,
            "last": pos == 255, "alternating": pos % 2 == 1,
            "random": rng.random(tiles * 256) < 0.4}[mask].astype(np.int32)
    stale = rng.integers(1, 99, tiles * 256)
    want = caps.cap_onehot_compact_plain(torch.as_tensor(x),
                                         torch.as_tensor(keep))
    _equal(want, _warp_compact(x, keep, stale))


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


def test_turns_cases_on_the_cpu(monkeypatch, capsys):
    """probes/turns.py's cases, this package standing in for the other on
    CPU tensors: P-1, the gathers, the rolls, P-8, P-9, P-10, P-11, P-13
    and H2's and H3's float64 sums, with their bounds (the rolls' by
    operations, their library call one rotation of the repetitions; P-9's
    one of its two cumsums; P-8's the 8 rows it reads and the rows it
    writes; P-11's the rows it writes, read once and written once); at the
    probes' own shapes each
    run equals its plain version, the float sums within their bound. The
    operators of cases W and F agree between the builds. Without CUDA its
    main exits 1."""
    monkeypatch.setattr(turns, "N_W", 1000)
    this = {"caps": caps, "gather": gather, "roll": roll,
            "tilesort": tilesort, "pkg": libgdf_tpu_torch}
    cases = turns.cases(torch.device("cpu"), this)
    assert [c["key"] for c in cases] == [
        "P-1", "P-3", "P-3@scale", "P-4", "P-4@scale", "P-5", "P-5@scale",
        "P-6", "P-7", "P-8", "P-9", "P-10", "P-10@scale", "P-13",
        "P-13@scale", "P-11", "P-11@scale", "K5a", "K5b"]
    bound = {c["key"]: c["bound_ms"] * turns.HBM_BYTES_PER_MS for c in cases}
    assert bound["P-1"] == 16 * tilesort.DEFAULT_N
    assert bound["P-10@scale"] == 12 * turns.COMPACT_SCALE_TILES * 256
    for k, moved in (("P-8", 4 * (8 + 16) * 128), ("P-9", 2 * 4 * 64 * 128),
                     ("P-11", 2 * 4 * 18 * 128),
                     ("P-11@scale", 2 * 4 * 5003 * 128),
                     ("P-13", 4 * 32 * 128 + 4),
                     ("P-13@scale", 4 * 8000 * 128 + 4),
                     ("K5a", 16 * 1000), ("K5b", 17 * 1000)):
        assert bound[k] == pytest.approx(moved, rel=1e-12)
    by_key = {c["key"]: c for c in cases}
    for k in ("K5a", "K5b"):
        c = by_key.pop(k)
        want = c["plain"]()
        for run in (c["this"], c["other"]):
            assert bool(((run() - want).abs() <= turns.REL_F64
                         * c["bound_abs"] + turns.REL_F64).all())
        if k == "K5a":
            assert torch.equal(c["library"](), want)
        else:
            assert c["library"] is None
    for k in ("P-8", "P-11", "P-11@scale"):
        assert by_key[k]["library"] is None
    cases = list(by_key.values())
    p9 = by_key.pop("P-9")
    assert p9["library_x"] == 2
    assert torch.equal(torch.cumsum(p9["library"](), 1, dtype=torch.int32),
                       p9["plain"]())
    for k in ("P-13", "P-13@scale"):
        assert torch.equal(by_key[k]["library"]().reshape(1, 1),
                           by_key[k]["plain"]())
        assert torch.equal(by_key[k]["this"](), by_key[k]["plain"]())
    rolls = [c for c in cases if c["key"] in ("P-6", "P-7")]
    x = torch.as_tensor(roll.probe_inputs()[0])
    for c in rolls:
        assert c["bound_ms"] == (2 * roll.REPS * x.numel()
                                 / turns.SCALAR_OPS_PER_MS)
        assert c["library_x"] == roll.REPS
        assert torch.equal(c["library"](), torch.roll(x, 1, 1))
    assert all(c["library_x"] == 1 for c in by_key.values()
               if c not in rolls)
    for c in cases:
        if "@" not in c["key"] and c["key"] != "P-1":
            assert turns._equal(c["this"](), c["plain"]())
            assert turns._equal(c["other"](), c["plain"]())
    monkeypatch.setattr(turns, "N_W", 1000)
    runs = turns.window_runs(torch.device("cpu"), libgdf_tpu_torch,
                             libgdf_tpu_torch)
    assert list(runs) == ["window_min_rows", "window_max_range"]
    for this, other in runs.values():
        a, b = this(), other()
        assert turns._equal(a.data, b.data) and torch.equal(a.valid, b.valid)
        assert turns._close(a, b)
    monkeypatch.setattr(turns, "N_FACT", 2000)
    monkeypatch.setattr(turns, "N_DIM", 200)
    runs = turns.flush_runs(torch.device("cpu"), libgdf_tpu_torch,
                            libgdf_tpu_torch)
    assert list(runs) == ["prefixsum_float64", "window_sum_rows",
                          "window_avg_running", "window_sum_range",
                          "groupby", "reductions"]
    for this, other in runs.values():
        assert turns._close(this(), other(), *turns.FLUSH_TOL)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert turns.main(["build/parent"]) == 1
    assert "CUDA" in capsys.readouterr().err


def test_probes_import_without_jax():
    code = ("import sys; from libgdf_tpu_torch import probes; "
            "from libgdf_tpu_torch.probes import caps, gather, roll, "
            "tilesort; probes.launch_counts(); "
            "print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "False"
