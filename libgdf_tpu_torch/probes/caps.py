"""P-8 .. P-11, P-13, P-14: the capability probes as a self-test.

Counterpart of `benchmarks/probe_pallas_caps.py`, which asks which Mosaic
features lower on the TPU. Each kernel (`csrc/probe_caps.cu`) computes
what its probe computes (P-12, `p5`, is `gather.lane_gather` at int32):

  cap_dyn_store       p1  store x[:8] into a zeroed (32, 128) scratch at row
                          x[0, 0] + 3 (an offset whose rows leave the
                          scratch raises, as the probe's store does in
                          interpret mode); out = its first rows. The kernel
                          has no scratch: one block, each thread loads
                          x[0, 0] and one 16-byte quad of x's first 8 rows
                          in one round, then stores it into the window
                          or zeros outside it (`store_window`)
  cap_cumsum2d        p2  cumsum over axis 0, then over axis 1: the tile
                          on chip at once (8 rows a warp as 16-byte loads),
                          a blocked column scan across the warps, each
                          warp's 8 row scans at once
  cap_onehot_compact  p3  stable compaction of each 256-element tile (the
                          TPU's one-hot matrix product), a warp a tile: a
                          scan of the lanes' kept counts, a staging row in
                          shared memory; the tail is 0; any 4-byte
                          alignment (16-byte loads where all three
                          pointers allow)
  cap_bulk_copy       p4  step b stages x[8b:8b+8] + 1000 and copies it to
                          out rows [5b, 5b + 8), a later step overwriting an
                          earlier one; rows past 5 (steps - 1) + 8 are not
                          written (nor on the TPU). The kernel computes the
                          closed form (`bulk_sources`): a warp 4 whole
                          output rows, every load before any store
  cap_carry           p6  the int32 sum of x, carried across 8-row tiles:
                          one block, every load of a 16 KB chunk issued
                          before the first add, the carry a sum in
                          registers (unsigned addition wraps and is
                          associative), one block reduction
  cap_dyn_loop        p7  out[0] = sum of x[i & 7] for i < (x[0, 0] & 7) + 2:
                          its closed form (`loop_counts`), a thread 4
                          columns; x[0, 0] and rows 0 and 1 in the first
                          round, rows 2..7 with them for a narrow x, else
                          only where the trip count reads them
                          (`loop_plan`)

Integer arithmetic wraps, as int32 does in jnp. Every cap kernel takes
views at any 4-byte alignment (16-byte accesses where x and out allow).

    python -m libgdf_tpu_torch.probes.caps [--device cpu]

prints OK / FAIL per capability under the probe's names, each kernel held
to its plain version and to the probe's own check on the probe's inputs,
and exits non-zero if any fails. p6 is held to the value its probe
asserts, 4096: the probe itself raises before it (its pallas_call passes
no scratch for the SMEM accumulator).
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..core.errors import GDFError
from ..ops.kernels import _lib
from . import _common
from .gather import lane_gather, lane_gather_plain

LANES = 128
SCRATCH_ROWS, STORE_ROWS = 32, 8        # p1
MAX_CUMSUM_ROWS = 64                    # p2
COMPACT_TILE = 256                      # p3
STEP_ROWS, STEP_ADVANCE = 8, 5          # p4, and p6's tile
LOOP_ROWS = 8                           # p7
# the widest x whose 8 rows cap_dyn_loop reads whatever its trip count:
# up to here that was no slower than reading only the rows the trip count
# needs, at any trip count, on the H100 (PERF.md §6)
LOOP_ALL_ROWS_COLS = 16_384
CAPS = ("cap_dyn_store", "cap_cumsum2d", "cap_onehot_compact",
        "cap_bulk_copy", "cap_carry", "cap_dyn_loop")


def _int32(v: int) -> int:
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


def _rows(what: str, x: torch.Tensor, lo: int, hi: int,
          multiple: int = 1) -> int:
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != LANES:
        raise TypeError(f"{what}: x must be int32 (rows, {LANES})")
    r = x.shape[0]
    if not lo <= r <= hi or r % multiple:
        raise ValueError(f"{what}: {r} rows")
    return r


# -- plain versions -----------------------------------------------------------

def store_start(x0: int) -> int:
    """p1's row offset x[0, 0] + 3 (int32); raises unless its 8 rows fit in
    the scratch, as the probe's store does in interpret mode."""
    start = _int32(x0 + 3)
    if not 0 <= start <= SCRATCH_ROWS - STORE_ROWS:
        raise ValueError(f"cap_dyn_store: rows [{start}, {start + 8}) are "
                         f"outside the {SCRATCH_ROWS}-row scratch")
    return start


def cap_dyn_store_plain(x: torch.Tensor) -> torch.Tensor:
    _rows("cap_dyn_store", x, STORE_ROWS, SCRATCH_ROWS)
    s = torch.zeros((SCRATCH_ROWS, LANES), dtype=x.dtype, device=x.device)
    start = store_start(int(x[0, 0]))
    s[start:start + STORE_ROWS] = x[:STORE_ROWS]
    return s[:x.shape[0]].clone()


def cap_cumsum2d_plain(x: torch.Tensor) -> torch.Tensor:
    _rows("cap_cumsum2d", x, 1, MAX_CUMSUM_ROWS)
    return torch.cumsum(torch.cumsum(x, 0, dtype=torch.int32), 1,
                        dtype=torch.int32)


def cap_onehot_compact_plain(x: torch.Tensor,
                             keep: torch.Tensor) -> torch.Tensor:
    _check_compact(x, keep)
    t = x.reshape(-1, COMPACT_TILE)
    k = keep.reshape(-1, COMPACT_TILE) != 0
    dest = torch.cumsum(k, 1) - k.long()
    out = torch.zeros((t.shape[0], COMPACT_TILE + 1), dtype=x.dtype,
                      device=x.device)
    out.scatter_(1, torch.where(k, dest, COMPACT_TILE), t)
    return out[:, :COMPACT_TILE].reshape(x.shape)


def bulk_rows(steps: int) -> int:
    """Rows of cap_bulk_copy's output that its steps write."""
    return STEP_ADVANCE * (steps - 1) + STEP_ROWS


def bulk_sources(steps: int) -> np.ndarray:
    """The x row that each written output row of cap_bulk_copy holds (plus
    1000), in the kernel's closed form: row r is written last by step
    b = min(r // 5, steps - 1), which puts x row 8b + (r - 5b) there."""
    r = np.arange(bulk_rows(steps))
    b = np.minimum(r // STEP_ADVANCE, steps - 1)
    return (STEP_ROWS - STEP_ADVANCE) * b + r


def store_window(x00: int, rows: int) -> np.ndarray:
    """cap_dyn_store's output rows as the kernel assigns them: the x row
    that output row r holds, or -1 for a row of zeros."""
    start = store_start(x00)
    r = np.arange(rows)
    return np.where((r >= start) & (r < start + STORE_ROWS), r - start, -1)


def cap_bulk_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """Rows past bulk_rows(steps) are 0 here and unspecified from the
    kernel."""
    steps = _rows("cap_bulk_copy", x, STEP_ROWS, 2 ** 20,
                  STEP_ROWS) // STEP_ROWS
    out = torch.zeros_like(x)
    for b in range(steps):
        off = STEP_ADVANCE * b
        out[off:off + STEP_ROWS] = x[STEP_ROWS * b:STEP_ROWS * (b + 1)] + 1000
    return out


def cap_carry_plain(x: torch.Tensor) -> torch.Tensor:
    _rows("cap_carry", x, STEP_ROWS, 2 ** 20, STEP_ROWS)
    return x.sum(dtype=torch.int32).reshape(1, 1)


def loop_trips(x00: int) -> int:
    """p7's run-time trip count."""
    return (x00 & 7) + 2


def loop_counts(x00: int) -> np.ndarray:
    """The times p7's loop adds row k of x, for k < 8, in the kernel's
    closed form: once for each k < min(n, 8) and once more for row 0 when
    n = 9, n = loop_trips(x00) in [2, 9]."""
    n = loop_trips(x00)
    k = np.arange(LOOP_ROWS)
    return (k < n).astype(np.int64) + (k + LOOP_ROWS < n)


def loop_bytes(x00: int, cols: int) -> int:
    """The bytes cap_dyn_loop must move for x (8, cols): the rows of x its
    trip count reads (x[0, 0] among them), each once, and the row it
    writes."""
    return (int(np.count_nonzero(loop_counts(x00))) + 1) * cols * 4


def loop_plan(cols: int) -> bool:
    """cap_dyn_loop's route for x (8, cols): True to load all 8 rows with
    x[0, 0] in one round trip (up to LOOP_ALL_ROWS_COLS columns), False to
    load rows 2..7 only where the trip count reads them."""
    return cols <= LOOP_ALL_ROWS_COLS


def cap_dyn_loop_plain(x: torch.Tensor) -> torch.Tensor:
    _check_loop(x)
    rows = [i & 7 for i in range(loop_trips(int(x[0, 0])))]
    return x[rows].sum(0, dtype=torch.int32).reshape(1, -1)


def _check_compact(x: torch.Tensor, keep: torch.Tensor) -> None:
    if x.dtype != torch.int32 or keep.dtype != torch.int32 or \
            keep.shape != x.shape:
        raise TypeError("cap_onehot_compact: x and keep must be int32 "
                        "tensors of one shape")
    if x.numel() % COMPACT_TILE:
        raise ValueError(f"cap_onehot_compact: {x.numel()} elements, not a "
                         f"multiple of {COMPACT_TILE}")


def _check_loop(x: torch.Tensor) -> None:
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != LOOP_ROWS \
            or x.shape[1] < 1:
        raise TypeError(f"cap_dyn_loop: x must be int32 ({LOOP_ROWS}, cols)")


# -- wrappers -----------------------------------------------------------------

def cap_dyn_store(x: torch.Tensor) -> torch.Tensor:
    """x int32 (rows, 128), 8 <= rows <= 32. Reads x[0, 0] on the host to
    check the offset."""
    rows = _rows("cap_dyn_store", x, STORE_ROWS, SCRATCH_ROWS)
    if _common.on_cpu(x):
        return cap_dyn_store_plain(x)
    _lib.require_cuda("cap_dyn_store", x)
    store_start(int(x[0, 0]))
    out = torch.empty_like(x)
    _common.launch(cap_dyn_store, "cap_dyn_store", "gdf_probe_cap_dyn_store",
                   x, out, rows)
    return out


def cap_cumsum2d(x: torch.Tensor) -> torch.Tensor:
    """x int32 (rows, 128), 1 <= rows <= 64."""
    rows = _rows("cap_cumsum2d", x, 1, MAX_CUMSUM_ROWS)
    if _common.on_cpu(x):
        return cap_cumsum2d_plain(x)
    out = torch.empty_like(x)
    _common.launch(cap_cumsum2d, "cap_cumsum2d", "gdf_probe_cap_cumsum2d", x,
                   out, rows)
    return out


def cap_onehot_compact(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """x, keep int32 of one contiguous shape, a multiple of 256 elements;
    each 256-element tile (in row-major order) compacted on its own."""
    _check_compact(x, keep)
    if _common.on_cpu(x, keep):
        return cap_onehot_compact_plain(x, keep)
    out = torch.empty_like(x)
    _common.launch(cap_onehot_compact, "cap_onehot_compact",
                   "gdf_probe_cap_onehot_compact", x, keep, out, x.numel())
    return out


def cap_bulk_copy(x: torch.Tensor) -> torch.Tensor:
    """x int32 (8 * steps, 128); rows past bulk_rows(steps) of the result
    are not written."""
    rows = _rows("cap_bulk_copy", x, STEP_ROWS, 2 ** 20, STEP_ROWS)
    if _common.on_cpu(x):
        return cap_bulk_copy_plain(x)
    out = torch.empty_like(x)
    _common.launch(cap_bulk_copy, "cap_bulk_copy", "gdf_probe_cap_bulk_copy",
                   x, out, rows // STEP_ROWS)
    return out


def cap_carry(x: torch.Tensor) -> torch.Tensor:
    """x int32 (8 * tiles, 128) -> its sum, (1, 1)."""
    rows = _rows("cap_carry", x, STEP_ROWS, 2 ** 20, STEP_ROWS)
    if _common.on_cpu(x):
        return cap_carry_plain(x)
    out = torch.empty((1, 1), dtype=x.dtype, device=x.device)
    _common.launch(cap_carry, "cap_carry", "gdf_probe_cap_carry", x, out,
                   rows // STEP_ROWS)
    return out


def cap_dyn_loop(x: torch.Tensor) -> torch.Tensor:
    """x int32 (8, cols) -> (1, cols), on the route of loop_plan(cols)."""
    _check_loop(x)
    if _common.on_cpu(x):
        return cap_dyn_loop_plain(x)
    out = torch.empty((1, x.shape[1]), dtype=x.dtype, device=x.device)
    _common.launch(cap_dyn_loop, "cap_dyn_loop", "gdf_probe_cap_dyn_loop", x,
                   out, x.shape[1], int(loop_plan(x.shape[1])))
    return out


for _name in CAPS:
    globals()[_name].launches = 0


# -- the probe's inputs and checks --------------------------------------------

def probe_inputs() -> dict:
    """{probe: numpy inputs}, as probe_pallas_caps.py builds them."""
    iota = np.arange(256, dtype=np.int32)
    return {
        "p1": (np.zeros((16, LANES), np.int32),),
        "p2": (np.ones((64, LANES), np.int32),),
        "p3": ((iota * 100001).reshape(2, LANES),
               (iota % 3 == 0).astype(np.int32).reshape(2, LANES)),
        "p4": (np.arange(24 * LANES, dtype=np.int32).reshape(24, LANES),),
        "p5": (np.arange(8 * LANES, dtype=np.int32).reshape(8, LANES),
               np.tile(np.arange(LANES - 1, -1, -1, dtype=np.int32),
                       (8, 1))),
        "p6": (np.ones((32, LANES), np.int32),),
        "p7": (np.ones((8, LANES), np.int32),),
    }


def probe_check(name: str, out: np.ndarray) -> bool:
    """The probe's own assertion on its output (p3's: the kept values, in
    order, then zeros)."""
    if name == "p1":
        return out.shape == (16, LANES) and not out.any()
    if name == "p2":
        return int(out[-1, -1]) == 64 * LANES
    if name == "p3":
        exp = (np.arange(256) * 100001)[np.arange(256) % 3 == 0]
        flat = out.reshape(-1)
        return np.array_equal(flat[:exp.size], exp) and \
            not flat[exp.size:].any()
    if name == "p4":
        x = probe_inputs()["p4"][0]
        return bool((out[5] == x[8] + 1000).all())
    if name == "p5":
        return int(out[0, 0]) == LANES - 1
    if name == "p6":
        return int(out[0, 0]) == 4 * 8 * LANES
    return int(out[0, 0]) == 3


# probe -> (its name in probe_pallas_caps.py, kernel, plain version, rows
# of the output that are specified)
PROBES = {
    "p1": ("dyn_vmem_store_1d", cap_dyn_store, cap_dyn_store_plain, None),
    "p2": ("cumsum_axis0_and_1", cap_cumsum2d, cap_cumsum2d_plain, None),
    "p3": ("onehot_matmul_i32_payload", cap_onehot_compact,
           cap_onehot_compact_plain, None),
    "p4": ("dma_hbm_dyn_offset", cap_bulk_copy, cap_bulk_copy_plain,
           bulk_rows(3)),
    "p5": ("dyn_gather_vmem", lane_gather, lane_gather_plain, None),
    "p6": ("smem_carry_across_grid", cap_carry, cap_carry_plain, None),
    "p7": ("dyn_trip_fori_loop", cap_dyn_loop, cap_dyn_loop_plain, None),
}


def run_probe(name: str, dev: torch.device) -> np.ndarray:
    """Probe `name`'s kernel on its inputs on `dev`, held to the plain
    version and to the probe's check; returns its specified rows."""
    _, kernel, plain, rows = PROBES[name]
    args = [torch.as_tensor(a, device=dev) for a in probe_inputs()[name]]
    got = kernel(*args).cpu()[:rows]
    want = plain(*[a.cpu() for a in args])[:rows]
    _common.require(torch.equal(got, want), f"{name}: kernel == plain")
    out = got.numpy()
    _common.require(probe_check(name, out), f"{name}: the probe's check")
    return out


def main(argv=None) -> int:
    args = _common.parser("caps", "Capability probes as a self-test."
                          ).parse_args(argv)
    dev = _common.device(args.device)
    if dev is None:
        return 1
    failed = 0
    for name, (probe_name, *_) in PROBES.items():
        t0 = time.perf_counter()
        try:
            run_probe(name, dev)
            _common.sync(dev)
        except (GDFError, RuntimeError, ValueError, TypeError) as e:
            failed += 1
            print(f"FAIL {probe_name}: {type(e).__name__}: {e}", flush=True)
        else:
            print(f"OK   {probe_name}  ({time.perf_counter() - t0:.1f}s)",
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
