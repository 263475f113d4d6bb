"""P-2 .. P-5 and P-12: the gathers of the cost probes.

Counterpart of `benchmarks/probe_pallas_gather.py` (and of
`probe_pallas_caps.py:138` `p5`, a lane gather at int32), which prices the
gathers that follow every sort in join, groupby and window:

    lane_gather(x, idx)      out[i, j] = x[i, idx[i, j]]      x (M, 128)
    sublane_gather(x, idx)   out[i, j] = x[idx[i, j], j]      x (T, 128)
    flat_take(table, idx)    out = table.reshape(-1)[idx]

over float32 or int32 values and int32 indices. Indices act as the probes'
`jnp.take` / `take_along_axis` do in interpret mode: one in [-size, 0)
counts from the end, and one outside [-size, size) gives NaN (float32) or
INT32_MIN (int32). The kernels (`csrc/probe_gather.cu`) hold the table on
chip: a row in its warp's shared memory, one round trip a row (lane); a
32-column slab per block of a persistent grid, staged once by TMA
(sublane, `sublane_plan`); for the flat take, the table's first words
resident in the shared memory of each block of a persistent grid and the
rest read through L1 / L2 (`take_plan`, `take_grid`).

    python -m libgdf_tpu_torch.probes.gather [--device cpu]

prints the probe's four lines: ok=, microseconds and Grows/s per gather,
on the probe's inputs (drawn as the probe draws them).
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from . import _common
from ..ops.kernels import _lib

LANES = 128
MAX_SUBLANE_ROWS = 1792         # a 32-column slab of 224 KB
# the kernels' geometry, as in csrc/probe_gather.cu
SUB_WARPS, SUB_ROWS_IN_FLIGHT = 32, 8   # a block's warps; rows a warp holds
TAKE_SLAB_WORDS = 49_152        # words a block holds, 192 KB
TAKE_THREADS = 1024
TAKE_WORDS_PER_THREAD = 8       # two 16-byte index vectors in flight
DTYPES = (torch.float32, torch.int32)
# the fill of an index outside the table, and its bits as an int32
FILL = {torch.float32: float("nan"), torch.int32: -2 ** 31}
FILL_BITS = {torch.float32: 0x7FC00000, torch.int32: -2 ** 31}


def _resolve(idx: torch.Tensor, size: int):
    """(the position each index names, clamped into the table; whether it
    names one)."""
    i = idx.long()
    i = torch.where(i < 0, i + size, i)
    ok = (i >= 0) & (i < size)
    return i.clamp(0, size - 1), ok


def _filled(out: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, out, torch.full((), FILL[out.dtype],
                                           dtype=out.dtype,
                                           device=out.device))


def _check_values(what: str, x: torch.Tensor, idx: torch.Tensor) -> None:
    if x.dtype not in DTYPES or idx.dtype != torch.int32:
        raise TypeError(f"{what}: values must be float32 or int32 and "
                        f"indices int32")


def _check_rows(what: str, x: torch.Tensor, idx: torch.Tensor) -> None:
    _check_values(what, x, idx)
    if x.dim() != 2 or x.shape[1] != LANES or idx.dim() != 2 or \
            idx.shape[1] != LANES:
        raise ValueError(f"{what}: x and idx must be (rows, {LANES})")


def lane_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    i, ok = _resolve(idx, LANES)
    return _filled(torch.take_along_dim(x, i, 1), ok)


def sublane_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    i, ok = _resolve(idx, x.shape[0])
    return _filled(torch.take_along_dim(x, i, 0), ok)


def flat_take_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    i, ok = _resolve(idx, table.numel())
    return _filled(table.reshape(-1)[i], ok)


def take_plan(n: int) -> int:
    """S, the words of a table of n words that each block of `flat_take`
    holds in shared memory: n rounded up to a multiple of 4, at most
    TAKE_SLAB_WORDS. Words past S are read through L1 / L2."""
    return min(-(-n // 4) * 4, TAKE_SLAB_WORDS)


def take_grid(n_idx: int, blocks_per_sm: int, sms: int) -> int:
    """Blocks of a persistent `flat_take` launch over n_idx indices: the
    blocks the card holds at once, never more than the indices fill, at
    least one."""
    need = -(-n_idx // (TAKE_THREADS * TAKE_WORDS_PER_THREAD))
    return max(1, min(blocks_per_sm * sms, need))


def sublane_plan(rows: int, sms: int, blocks_per_sm: int):
    """(chunk_rows, grid) of a persistent `sublane_gather` over `rows`
    index rows: G = the smaller of the blocks the card holds at once (a
    multiple of 4) and 4 x the row chunks, block b serving slab b % 4. A
    chunk is SUB_WARPS x k rows, k rows a warp, the largest k up to
    SUB_ROWS_IN_FLIGHT that still gives every block a chunk."""
    most = max(4, sms * blocks_per_sm // 4 * 4)
    k = SUB_ROWS_IN_FLIGHT
    while k > 1 and 4 * -(-rows // (SUB_WARPS * k)) < most:
        k //= 2
    chunk = SUB_WARPS * k
    return chunk, min(most, 4 * -(-rows // chunk))


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def lane_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, j] = x[i, idx[i, j]]; x and idx (M, 128)."""
    _check_rows("lane_gather", x, idx)
    if idx.shape != x.shape:
        raise ValueError("lane_gather: x and idx must have one shape")
    if _common.on_cpu(x, idx):
        return lane_gather_plain(x, idx)
    out = torch.empty_like(x)
    _common.launch(lane_gather, "lane_gather", "gdf_probe_lane_gather", x,
                   idx, out, x.shape[0], FILL_BITS[x.dtype])
    return out


def sublane_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, j] = x[idx[i, j], j]; x (T, 128) with 1 <= T <= 1792, idx
    (M, 128)."""
    _check_rows("sublane_gather", x, idx)
    if not 1 <= x.shape[0] <= MAX_SUBLANE_ROWS:
        raise ValueError(f"sublane_gather: x has {x.shape[0]} rows, not "
                         f"1 .. {MAX_SUBLANE_ROWS}")
    if _common.on_cpu(x, idx):
        return sublane_gather_plain(x, idx)
    dev = _lib.require_cuda("sublane_gather", x, idx)
    chunk, grid = sublane_plan(
        idx.shape[0], _sms(dev),
        _common.units(dev.index, "gdf_probe_sublane_occupancy", x.shape[0]))
    out = torch.empty(idx.shape, dtype=x.dtype, device=x.device)
    _common.launch(sublane_gather, "sublane_gather",
                   "gdf_probe_sublane_gather", x, x.shape[0], idx, out,
                   idx.shape[0], FILL_BITS[x.dtype], chunk, grid)
    return out


def flat_take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table.reshape(-1)[idx], of idx's shape; the table has at least one
    element."""
    _check_values("flat_take", table, idx)
    if table.numel() == 0:
        raise ValueError("flat_take: empty table")
    if _common.on_cpu(table, idx):
        return flat_take_plain(table, idx)
    dev = _lib.require_cuda("flat_take", table, idx)
    slab = take_plan(table.numel())
    grid = take_grid(idx.numel(), _common.units(
        dev.index, "gdf_probe_flat_take_occupancy", slab), _sms(dev))
    out = torch.empty(idx.shape, dtype=table.dtype, device=table.device)
    _common.launch(flat_take, "flat_take", "gdf_probe_flat_take", table,
                   table.numel(), idx, out, idx.numel(),
                   FILL_BITS[table.dtype], slab, grid)
    return out


for _fn in (lane_gather, sublane_gather, flat_take):
    _fn.launches = 0


def probe_inputs(seed: int = 0):
    """The probe's four cases as numpy, drawn in its order from one
    generator: [(name, kind, values, indices)]."""
    rng = np.random.default_rng(seed)
    x1 = rng.standard_normal((1024, LANES)).astype(np.float32)
    i1 = rng.integers(0, LANES, (1024, LANES)).astype(np.int32)
    x2 = rng.standard_normal((1024, LANES)).astype(np.float32)
    i2 = rng.integers(0, 1024, (1024, LANES)).astype(np.int32)
    t3 = rng.standard_normal(1 << 16).astype(np.float32)
    i3 = rng.integers(0, 1 << 16, (8192, LANES)).astype(np.int32)
    t4 = rng.standard_normal((512, LANES)).astype(np.float32)
    i4 = rng.integers(0, 512 * LANES, (8192, LANES)).astype(np.int32)
    return [("lane gather take_along_axis(axis=1)", "lane", x1, i1),
            ("sublane gather take_along_axis(axis=0)", "sublane", x2, i2),
            ("flat take 64K-table 1M idx", "flat", t3, i3),
            ("flat take 2d-reshaped table", "flat", t4, i4)]


GATHERS = {"lane": lane_gather, "sublane": sublane_gather,
           "flat": flat_take}
PLAIN = {"lane": lane_gather_plain, "sublane": sublane_gather_plain,
         "flat": flat_take_plain}
NUMPY = {"lane": lambda x, i: np.take_along_axis(x, i, axis=1),
         "sublane": lambda x, i: np.take_along_axis(x, i, axis=0),
         "flat": lambda t, i: t.reshape(-1)[i]}


def main(argv=None) -> int:
    args = _common.parser("gather", "Gathers from a table held on chip."
                          ).parse_args(argv)
    dev = _common.device(args.device)
    if dev is None:
        return 1
    ok_all = True
    for name, kind, x, idx in probe_inputs():
        fn = GATHERS[kind]
        xt = torch.as_tensor(x, device=dev)
        it = torch.as_tensor(idx, device=dev)
        ok = bool(np.array_equal(fn(xt, it).cpu().numpy(),
                                 NUMPY[kind](x, idx)))
        ok_all &= ok
        ms = _common.time_ms(lambda: fn(xt, it), dev)
        print(f"{name:46s} ok={ok}  {ms * 1e3:9.1f} us  "
              f"{idx.size / (ms / 1e3) / 1e9:7.3f} Grows/s", flush=True)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
