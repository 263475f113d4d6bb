"""Build and load the Hopper kernels: nvcc -> shared library -> ctypes.

The CUDA sources in `libgdf_tpu_torch/csrc/` have a plain C interface (no
PyTorch headers), so `nvcc` builds them in seconds: one compiler process
per source, all started together, then one link. The library is built at
the first kernel launch, keyed by a hash of the sources and flags, into
`build/kernels/` at the root of the checkout, and loaded once per process.
Nothing here runs at import time, so the package imports on a machine
without CUDA.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from ...core.errors import GDFError, GDFStatus

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_PI = ctypes.POINTER(ctypes.c_int)
_I = ctypes.c_int
_I64 = ctypes.c_int64

# C entry point -> (restype, argtypes). Every pointer and the stream are
# c_void_p: without argtypes ctypes would pass them as 32-bit ints.
_SIGNATURES = {
    "gdf_cuda_error_string": (ctypes.c_char_p, [_I]),
    "gdf_scan_scratch_bytes": (_I64, [_I, _I64]),
    "gdf_scan": (_I, [_I, _I, _I, _P, _P, _I64, _P, _I64, _P]),
    "gdf_seg_scan_scratch_bytes": (_I64, [_I, _I64]),
    "gdf_seg_scan": (_I, [_I, _I, _P, _P, _P, _I64, _P, _I64, _P]),
    "gdf_compact_max_arrays": (_I, []),
    "gdf_compact_scratch_bytes": (_I64, [_I64]),
    "gdf_compact": (_I, [_P, _I64, _I, _PP, _PP, _PI, _P, _P, _I64, _P]),
    "gdf_expand_max_words": (_I, []),
    "gdf_expand_fill": (_I, [_P, _I64, _I64, _I, _PP, _PP, _PI, _P]),
    "gdf_dense_plan_bytes": (_I64, []),
    "gdf_domain_probe_scratch_bytes": (_I64, [_I64, _I, _PI]),
    "gdf_domain_probe": (_I, [_P, _P, _P, _I64, _P]),
    "gdf_dense_groupby_scratch_bytes": (_I64, [_I, _I, _I64, _PI]),
    "gdf_dense_groupby": (_I, [_I, _P, _P, _I64, _P]),
    # the cost probes (libgdf_tpu_torch/probes/)
    "gdf_probe_tile_sort_clusters": (_I, [_PI]),
    "gdf_probe_tile_sort": (_I, [_P, _P, _P, _P, _I64, _P]),
    "gdf_probe_lane_gather": (_I, [_P, _P, _P, _I64, _I, _P]),
    "gdf_probe_sublane_occupancy": (_I, [_I, _PI]),
    "gdf_probe_sublane_gather": (_I, [_P, _I, _P, _P, _I64, _I, _I, _I, _P]),
    "gdf_probe_flat_take_occupancy": (_I, [_I, _PI]),
    "gdf_probe_flat_take": (_I, [_P, _I64, _P, _P, _I64, _I, _I, _I, _P]),
    "gdf_probe_roll_static": (_I, [_P, _P, _I64, _I, _P]),
    "gdf_probe_roll_dynamic": (_I, [_P, _P, _P, _I64, _I, _P]),
    "gdf_probe_cap_dyn_store": (_I, [_P, _P, _I, _P]),
    "gdf_probe_cap_cumsum2d": (_I, [_P, _P, _I, _P]),
    "gdf_probe_cap_onehot_compact": (_I, [_P, _P, _P, _I64, _P]),
    "gdf_probe_cap_bulk_copy": (_I, [_P, _P, _I, _P]),
    "gdf_probe_cap_carry": (_I, [_P, _P, _I, _P]),
    "gdf_probe_cap_dyn_loop": (_I, [_P, _P, _I, _I, _P]),
}

_LOCK = threading.Lock()
_LIB = None
COUNT_LOCK = threading.Lock()


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libgdf_tpu_torch_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise GDFError(GDFStatus.GDF_CUDA_ERROR, "nvcc not found (set CUDA_HOME)")


def build() -> Path:
    """Compile the kernels for sm_90a unless the library for these sources
    exists already. Returns the library's path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        jobs = []
        for src in sources():
            if src.suffix == ".cu":
                obj = os.path.join(tmp, src.stem + ".o")
                jobs.append((obj, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
        logs = [(p.communicate()[0], p.returncode) for _, p in jobs]
        if any(rc != 0 for _, rc in logs):
            raise GDFError(GDFStatus.GDF_CUDA_ERROR,
                           "nvcc failed:\n" + "".join(log for log, _ in logs))
        so = os.path.join(tmp, out.name)
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", so,
                              *[obj for obj, _ in jobs]],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise GDFError(GDFStatus.GDF_CUDA_ERROR,
                           "nvcc failed:\n" + res.stdout + res.stderr)
        os.replace(so, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            so = ctypes.CDLL(str(build()))
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.restype = res
                fn.argtypes = args
            _LIB = so
        return _LIB


def count_launch(wrapper, dtype: torch.dtype | None = None) -> None:
    """Add one to `wrapper.launches` and, given a dtype, to its count in
    `wrapper.launches_by_dtype`, under a lock: the shards of an in-process
    mesh launch from one thread each."""
    with COUNT_LOCK:
        wrapper.launches += 1
        if dtype is not None:
            key = str(dtype).removeprefix("torch.")
            by = wrapper.launches_by_dtype
            by[key] = by.get(key, 0) + 1


def reset_counts(wrapper) -> None:
    with COUNT_LOCK:
        wrapper.launches = 0
        if hasattr(wrapper, "launches_by_dtype"):
            wrapper.launches_by_dtype = {}


def check(err: int, what: str) -> None:
    """Raise if a C launcher returned a non-zero cudaError_t."""
    if err != 0:
        msg = lib().gdf_cuda_error_string(err).decode()
        raise GDFError(GDFStatus.GDF_CUDA_ERROR, f"{what}: {msg} ({err})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def pointer_array(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def int_array(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


def require_cuda(what: str, *tensors) -> torch.device:
    """Check that every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: tensors must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    return dev
