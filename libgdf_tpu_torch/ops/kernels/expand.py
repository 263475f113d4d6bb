"""H4 `expand_fill`: monotone expand-fill, the inverse of compaction.

Wrapper around `csrc/expand.cu` (which names the Pallas kernel it
replaces), beside its plain PyTorch version. On CPU tensors the wrapper
runs the plain version; on CUDA tensors it launches the kernel or raises.

    out_w[j] = w[max{i : pos[i] <= j}]   (0 where no pos[i] <= j), j < cap

`pos` is int32 and strictly increasing over the live sources, with a tail
of values >= cap (SENTINEL); words are int32 or int64 of pos's length. The
kernel is a tiled fill: one search per run of 4096 slots, not per slot.
"""
from __future__ import annotations

import torch

from . import _lib

SENTINEL = 2 ** 30  # tail positions; cap must stay below it


def expand_fill_plain(pos: torch.Tensor, words, cap: int):
    """Plain version: searchsorted(pos, arange(cap), right) - 1, gather."""
    if pos.shape[0] == 0:
        return [torch.zeros(cap, dtype=w.dtype, device=w.device)
                for w in words]
    j = torch.arange(cap, dtype=pos.dtype, device=pos.device)
    k = torch.searchsorted(pos, j, right=True) - 1
    live = k >= 0
    kc = k.clamp(min=0)
    return [torch.where(live, w[kc], torch.zeros((), dtype=w.dtype,
                                                 device=w.device))
            for w in words]


def expand_fill(pos: torch.Tensor, words, cap: int):
    """Returns one tensor of length `cap` per word."""
    words = list(words)
    cap = int(cap)
    if pos.dtype != torch.int32 or pos.dim() != 1:
        raise TypeError("expand_fill: pos must be a 1-D int32 tensor")
    for w in words:
        if w.dtype not in (torch.int32, torch.int64) or w.shape != pos.shape:
            raise TypeError("expand_fill: words must be int32/int64 tensors "
                            "of pos's length")
    if not 0 <= cap < SENTINEL:
        raise ValueError(f"expand_fill: cap {cap} outside [0, 2^30)")
    if all(t.device.type == "cpu" for t in [pos, *words]):
        return expand_fill_plain(pos, words, cap)
    dev = _lib.require_cuda("expand_fill", pos, *words)
    outs = [torch.empty(cap, dtype=w.dtype, device=dev) for w in words]
    if cap == 0 or not words:
        return outs
    lib = _lib.lib()
    per_launch = lib.gdf_expand_max_words()
    with torch.cuda.device(dev):
        stream = _lib.stream_ptr(dev)
        for i in range(0, len(words), per_launch):
            ins, chunk = words[i:i + per_launch], outs[i:i + per_launch]
            _lib.check(lib.gdf_expand_fill(
                pos.data_ptr(), pos.shape[0], cap, len(ins),
                _lib.pointer_array(ins), _lib.pointer_array(chunk),
                _lib.int_array([w.element_size() for w in ins]), stream),
                "expand_fill")
    expand_fill.launches += 1
    return outs


expand_fill.launches = 0
