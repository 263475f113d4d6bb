"""H2 `scan` and H3 `seg_scan`: inclusive (segmented) prefix scans.

Wrappers around `csrc/scan.cu` (which names the Pallas kernels it
replaces), each beside its plain PyTorch version. On a CPU tensor the
wrapper runs the plain version; on a CUDA tensor it launches the kernel or
raises.

  scan(kind, x, reverse)      kind in {sum, max, min}
  seg_scan(kind, flags, vals) kind in {sum, max, min, carry}: restarts at
                              flagged heads; `carry` fills forward the last
                              flagged value, and positions before any flag
                              keep their own value.

Value dtypes: int32, int64, float32, float64. Integer sums wrap; float
max/min propagate NaN. Each wrapper counts its launches in total
(`launches`) and per value dtype (`launches_by_dtype`, keyed "int64" and
so on): H2 at int64 and float64 is what replaces the TPU's K4a and K5a.
"""
from __future__ import annotations

import torch

from . import _lib

_DTYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
           torch.float64: 3}
_KINDS = {"sum": 0, "max": 1, "min": 2, "carry": 3}
_OPS = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}


def scan_plain(kind: str, x: torch.Tensor, reverse: bool = False):
    """Plain version of `scan`: torch.cumsum / cummax / cummin."""
    if x.shape[0] == 0:
        return x.clone()
    if reverse:
        x = torch.flip(x, [0])
    if kind == "sum":
        out = torch.cumsum(x, 0, dtype=x.dtype)
    elif kind == "max":
        out = torch.cummax(x, 0).values
    else:
        out = torch.cummin(x, 0).values
    return torch.flip(out, [0]) if reverse else out


def seg_scan_plain(kind: str, flags: torch.Tensor, vals: torch.Tensor):
    """Plain version of `seg_scan`: a log-step doubling scan with the pair
    combine (fa, va) + (fb, vb) = (fa | fb, fb ? vb : op(va, vb))
    (libgdf_tpu/ops/engine.py:243-251, and :295-300 for `carry`)."""
    f = flags.to(torch.bool)
    v = vals
    n = v.shape[0]
    s = 1
    while s < n:
        fb, vb = f[s:], v[s:]
        if kind == "carry":
            nv = torch.where(fb, vb, v[:-s])
        else:
            nv = torch.where(fb, vb, _OPS[kind](v[:-s], vb))
        v = torch.cat([v[:s], nv])
        f = torch.cat([f[:s], fb | f[:-s]])
        s <<= 1
    if kind == "carry":
        v = torch.where(f, v, vals)
    return v.clone() if v is vals else v


def _launch(what: str, kind: str, flags, vals: torch.Tensor):
    if vals.dtype not in _DTYPES:
        raise TypeError(f"{what}: unsupported dtype {vals.dtype}")
    dev = _lib.require_cuda(what, vals, *(() if flags is None else (flags,)))
    n = vals.shape[0]
    out = torch.empty_like(vals)
    if n == 0:
        return out
    lib = _lib.lib()
    ntiles = -(-n // lib.gdf_scan_tile_elems())
    tile_f = torch.empty(ntiles, dtype=torch.int32, device=dev)
    tile_v = torch.empty(ntiles, dtype=vals.dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib.gdf_scan(_DTYPES[vals.dtype], _KINDS[kind],
                           None if flags is None else flags.data_ptr(),
                           vals.data_ptr(), out.data_ptr(), n,
                           tile_f.data_ptr(), tile_v.data_ptr(),
                           _lib.stream_ptr(dev))
    _lib.check(err, what)
    return out


def scan(kind: str, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive scan (sum/max/min) of a 1-D tensor; `reverse` scans
    suffixes (the kernel runs on the flipped tensor)."""
    if kind not in ("sum", "max", "min"):
        raise ValueError(f"scan: unknown kind {kind!r}")
    if x.dim() != 1:
        raise ValueError("scan: 1-D tensors only")
    if x.device.type == "cpu":
        return scan_plain(kind, x, reverse)
    if reverse:
        return torch.flip(scan(kind, torch.flip(x, [0])), [0])
    out = _launch("scan", kind, None, x)
    if x.shape[0]:
        _count(scan, x.dtype)
    return out


def _count(wrapper, dtype: torch.dtype) -> None:
    wrapper.launches += 1
    key = str(dtype).removeprefix("torch.")
    wrapper.launches_by_dtype[key] = wrapper.launches_by_dtype.get(key, 0) + 1


scan.launches = 0
scan.launches_by_dtype = {}


def seg_scan(kind: str, flags: torch.Tensor, vals: torch.Tensor):
    """Inclusive segmented scan (sum/max/min) restarting at flagged heads,
    or the flagged carry-forward fill (`carry`)."""
    if kind not in _KINDS:
        raise ValueError(f"seg_scan: unknown kind {kind!r}")
    if vals.dim() != 1 or flags.shape != vals.shape:
        raise ValueError("seg_scan: flags and vals must be 1-D, same length")
    if vals.device.type == "cpu" and flags.device.type == "cpu":
        return seg_scan_plain(kind, flags, vals)
    if flags.dtype != torch.bool:
        flags = flags != 0
    out = _launch("seg_scan", kind, flags, vals)
    if vals.shape[0]:
        _count(seg_scan, vals.dtype)
    return out


seg_scan.launches = 0
seg_scan.launches_by_dtype = {}
