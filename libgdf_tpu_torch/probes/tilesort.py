"""P-1 `tile_sort`: each 65,536-element block of (key, payload) sorted.

Counterpart of `benchmarks/probe_tilesort.py` (`tile_sort`, l.91), the
kill-or-keep probe of a sort written for the chip: a bitonic sort of each
block, ascending by (key, payload), both signed int32, so that keys that
tie come out in payload order. A block of 2^16 elements takes 136
compare-exchange stages (sizes 2^1 .. 2^16); a full sort of npad = 2^m
elements as tile sort + merge would add (m - 16) x 16 in-block stages and
(m - 16)(m - 15)/2 cross-block passes (device-memory bound, taken as
free), so its rate is estimated as

    full-sort rows/s ~= tile_rate * tile_stages / in_block_stages * n / npad

(`stage_counts`: 136 / 264 / 36 for 2^24 elements). The kernel
(`csrc/probe_tilesort.cu`) is one launch of 4-CTA thread-block clusters,
a cluster per block: each CTA holds a 16,384-element tile as 32 packed
words in each of 512 threads' registers, runs every stage there, uses
shared memory only to move words between threads (a change of layout,
`schedule`) and reads a peer CTA's shared memory for the three stages
across tiles.

    python -m libgdf_tpu_torch.probes.tilesort [n] [--device cpu]

prints one JSON line: n, build_s (the first call, the kernels' build
included), the tile sort's rate and time, the full-sort estimate, the
library's whole-array two-operand sort (`torch.sort` of the keys and a
gather of the payload) and the verdict: "keep" if the estimate exceeds
1.3 x the library's rate.
"""
from __future__ import annotations

import json
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ..core.errors import GDFError, GDFStatus
from ..ops.kernels import _lib
from . import _common

LANES = 128
ROWS = 512
BLOCK = ROWS * LANES            # 65,536 elements per sorted block
K = BLOCK.bit_length() - 1      # 16
DEFAULT_N = 11 * 2 ** 20
KEEP_MARGIN = 1.3
# the kernel's geometry: a 4-CTA cluster a block, 2^14 elements a CTA,
# 2^5 words a thread
TILE_LOG, REG_LOG = 14, 5
THREADS = 2 ** (TILE_LOG - REG_LOG)
CROSS = (0, 10, 11, 12, 13)     # register bits of the layout across tiles


def stage_counts(block: int = BLOCK, npad: int = 2 ** 24):
    """(compare-exchange stages of one block's bitonic sort, in-block
    stages of a full bitonic sort of npad elements by blocks, cross-block
    passes of that sort); block and npad powers of two."""
    k = block.bit_length() - 1
    m = npad.bit_length() - 1
    tile = k * (k + 1) // 2
    return tile, tile + (m - k) * k, (m - k) * (m - k + 1) // 2


class Phase(NamedTuple):
    """A phase of the kernel: `where` is "registers" (each stage between
    two of a thread's registers) or "cluster" (the stage across tiles,
    each word against the word at the same index of a peer CTA); `layout`
    holds the tile's index bits that are register bits, in register-bit
    order (the thread has the others, in order). Words change layout
    through shared memory between phases of different layouts; a cluster
    phase reads them from shared memory in its layout."""
    where: str
    layout: tuple
    stages: list


def window(base: int) -> tuple:
    return tuple(range(base, base + REG_LOG))


def schedule() -> list:
    """P-1's 136 stages (k, j), size 2^k at distance 2^j, as
    `csrc/probe_tilesort.cu` runs them, in phases (`Phase`): sizes 2 .. 32
    in window 0; each size up to the tile in layouts of 5 index bits from
    its top stage down; each size past the tile a cluster stage per bit
    above the tile, then its 14 stages in the tile."""
    phases = [Phase("registers", window(0),
                    [(k, j) for k in range(1, REG_LOG + 1)
                     for j in range(k - 1, -1, -1)])]
    for k in range(REG_LOG + 1, TILE_LOG + 1):
        for hi in range(k - 1, -1, -REG_LOG):
            base = max(hi - (REG_LOG - 1), 0)
            phases.append(Phase("registers", window(base),
                                [(k, j) for j in range(hi, base - 1, -1)]))
    for k in range(TILE_LOG + 1, K + 1):
        for j in range(k - 1, TILE_LOG - 1, -1):
            phases.append(Phase("cluster", CROSS, [(k, j)]))
        for layout, hi, lo in ((CROSS, 13, 10), (window(5), 9, 5),
                               (window(0), 4, 0)):
            phases.append(Phase("registers", layout,
                                [(k, j) for j in range(hi, lo - 1, -1)]))
    return phases


def layout_index(layout: tuple) -> np.ndarray:
    """(THREADS, 2^REG_LOG) tile index of thread t's register e."""
    t = np.arange(THREADS)[:, None]
    e = np.arange(2 ** REG_LOG)[None, :]
    idx = np.zeros((THREADS, 2 ** REG_LOG), dtype=np.int64)
    for r, bit in enumerate(layout):
        idx |= (e >> r & 1) << bit
    rest = [b for b in range(TILE_LOG) if b not in layout]
    for r, bit in enumerate(rest):
        idx |= (t >> r & 1) << bit
    return idx


def slot(i):
    """Shared-memory slot of tile index i (8-byte words)."""
    return i ^ (i >> 5 & 15)


def pack(key: torch.Tensor, pay: torch.Tensor) -> torch.Tensor:
    """int64 words whose signed order is (key, pay)'s: key in the high
    half, pay with its sign bit flipped in the low half."""
    return (key.long() << 32) | (pay.long() + 2 ** 31)


def unpack(words: torch.Tensor):
    return ((words >> 32).int(),
            ((words & 0xFFFFFFFF) - 2 ** 31).int())


def _check(key: torch.Tensor, pay: torch.Tensor) -> int:
    if key.dtype != torch.int32 or pay.dtype != torch.int32 or \
            key.dim() != 1 or pay.shape != key.shape:
        raise TypeError("tile_sort: key and pay must be 1-D int32 tensors "
                        "of one length")
    n = key.shape[0]
    if n % BLOCK:
        raise ValueError(f"tile_sort: n = {n} is not a multiple of {BLOCK}")
    return n


def tile_sort_plain(key: torch.Tensor, pay: torch.Tensor):
    """Plain version: one torch.sort of the packed words, block by block."""
    _check(key, pay)
    words = pack(key, pay).view(-1, BLOCK)
    return unpack(torch.sort(words, dim=1).values.reshape(-1))


def tile_sort(key: torch.Tensor, pay: torch.Tensor):
    """(keys, payloads) with each 65,536-element block sorted ascending by
    (key, payload); n a multiple of 65,536."""
    n = _check(key, pay)
    if _common.on_cpu(key, pay):
        return tile_sort_plain(key, pay)
    dev = _lib.require_cuda("tile_sort", key, pay)
    ko, po = torch.empty_like(key), torch.empty_like(pay)
    if n:
        if _common.units(dev.index, "gdf_probe_tile_sort_clusters") == 0:
            raise GDFError(GDFStatus.GDF_CUDA_ERROR,
                           f"tile_sort: {torch.cuda.get_device_name(dev)} "
                           f"cannot schedule a cluster of 4 CTAs with "
                           f"128 KB of shared memory each")
        _common.launch(tile_sort, "tile_sort", "gdf_probe_tile_sort", key,
                       pay, ko, po, n)
    return ko, po


tile_sort.launches = 0


def sort_2op(key: torch.Tensor, pay: torch.Tensor):
    """The probe's baseline: the library's sort of the whole array by key,
    the payload gathered after it."""
    keys, order = torch.sort(key)
    return keys, pay[order]


def main(argv=None) -> int:
    ap = _common.parser("tilesort", "Tile sort against the library sort.")
    ap.add_argument("n", nargs="?", type=int, default=DEFAULT_N,
                    help="elements, rounded down to a multiple of 65,536")
    args = ap.parse_args(argv)
    dev = _common.device(args.device)
    if dev is None:
        return 1
    n = (args.n // BLOCK) * BLOCK
    _common.require(n > 0, f"n >= {BLOCK}")
    rng = np.random.default_rng(0)
    key = torch.as_tensor(rng.integers(0, 2 ** 31 - 1, n).astype(np.int32),
                          device=dev)
    pay = torch.arange(n, dtype=torch.int32, device=dev)

    t0 = time.perf_counter()
    ko, po = tile_sort(key, pay)
    kh = ko.cpu()
    build_s = time.perf_counter() - t0
    kc = key.cpu()
    _common.require(torch.equal(kh.view(-1, BLOCK),
                                torch.sort(kc.view(-1, BLOCK), 1).values),
                    "every block sorted")
    _common.require(torch.equal(kc[po.cpu().long()], kh),
                    "key[payload] == the sorted keys")

    tile_ms = _common.time_ms(lambda: tile_sort(key, pay), dev)
    lib_ms = _common.time_ms(lambda: sort_2op(key, pay), dev)
    npad = 1 << (n - 1).bit_length()
    tile_stages, in_block, _ = stage_counts(BLOCK, npad)
    tile_rate = n / (tile_ms / 1e3)
    lib_rate = n / (lib_ms / 1e3)
    full_est = tile_rate * tile_stages / in_block * (n / npad)
    print(json.dumps({
        "n": n, "build_s": round(build_s, 1),
        "tile_sort_rows_per_s": round(tile_rate),
        "tile_sort_ms": round(tile_ms, 4),
        "full_sort_est_rows_per_s": round(full_est),
        "torch_sort_2op_rows_per_s": round(lib_rate),
        "torch_sort_ms": round(lib_ms, 4),
        "verdict": "keep" if full_est > KEEP_MARGIN * lib_rate else "kill",
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
