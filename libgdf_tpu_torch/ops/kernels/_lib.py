"""Build and load the Hopper kernels: nvcc -> shared library -> ctypes.

The CUDA sources in `libgdf_tpu_torch/csrc/` have a plain C interface (no
PyTorch headers), so `nvcc` builds them in seconds. A `Library` is a name,
its sources and the signatures of its C entry points. It is built at its
first launch, one compiler process per source, all started together, then
one link, keyed by a hash of its sources and flags, into `build/kernels/`
at the root of the checkout, and loaded once per process. `KERNELS` is the
operators' library (H1-H7): `lib()`, `build()`, `library_path()` and
`check()` are its. The cost probes build their own (`probes/_common.py`).
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

# The dtype codes of H5's and H6's columns (`gdf::dtype` in csrc/common.cuh).
DTYPE_CODES = {torch.int8: 0, torch.int16: 1, torch.int32: 2,
               torch.int64: 3, torch.uint8: 4, torch.bool: 4,
               torch.float32: 5, torch.float64: 6}


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


class Library:
    """A shared library of kernels: `name`, its `sources` in `csrc/` (the
    .cu files are compiled; the headers they include enter the hash) and
    `signatures`, {C entry point: (restype, argtypes)}. Every pointer and
    the stream are c_void_p: without argtypes ctypes would pass them as
    32-bit ints. Every library also exports `gdf_cuda_error_string`
    (common.cuh), which `check` reads its own errors with."""

    def __init__(self, name: str, sources, signatures: dict):
        self.name = name
        self.files = tuple(sources)
        self.signatures = {"gdf_cuda_error_string": (ctypes.c_char_p, [_I]),
                           **signatures}
        self._lock = threading.Lock()
        self._so = None

    def sources(self) -> list:
        return [CSRC / f for f in self.files]

    def path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in self.sources():
            h.update(p.name.encode())
            h.update(p.read_bytes())
        name = f"libgdf_tpu_torch_{self.name}_{h.hexdigest()[:16]}.so"
        return BUILD_DIR / name

    def build(self) -> Path:
        """Compile the sources for sm_90a unless the library for them
        exists already. Returns the library's path."""
        out = self.path()
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
            jobs = []
            for src in self.sources():
                if src.suffix == ".cu":
                    obj = os.path.join(tmp, src.stem + ".o")
                    jobs.append((obj, subprocess.Popen(
                        [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                        text=True)))
            logs = [(p.communicate()[0], p.returncode) for _, p in jobs]
            if any(rc != 0 for _, rc in logs):
                raise GDFError(GDFStatus.GDF_CUDA_ERROR, "nvcc failed:\n" +
                               "".join(log for log, _ in logs))
            so = os.path.join(tmp, out.name)
            res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", so,
                                  *[obj for obj, _ in jobs]],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise GDFError(GDFStatus.GDF_CUDA_ERROR,
                               "nvcc failed:\n" + res.stdout + res.stderr)
            os.replace(so, out)
        return out

    def load(self) -> ctypes.CDLL:
        """The loaded library (built on first use)."""
        with self._lock:
            if self._so is None:
                so = ctypes.CDLL(str(self.build()))
                for name, (res, args) in self.signatures.items():
                    fn = getattr(so, name)
                    fn.restype = res
                    fn.argtypes = args
                self._so = so
            return self._so

    def check(self, err: int, what: str) -> None:
        """Raise if a C launcher of this library returned a non-zero
        cudaError_t."""
        if err != 0:
            msg = self.load().gdf_cuda_error_string(err).decode()
            raise GDFError(GDFStatus.GDF_CUDA_ERROR, f"{what}: {msg} ({err})")


KERNELS = Library("kernels", (
    "compact.cu", "dense_groupby.cu", "expand.cu", "hash_join.cu", "scan.cu",
    "common.cuh", "lookback.cuh"), {
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
    "gdf_wide_groupby_scratch_bytes": (_I64, [_I64, _I, _PI]),
    "gdf_wide_groupby": (_I, [_I64, _P, _P, _I64, _P]),
    "gdf_hash_slots": (_I64, [_I64]),
    "gdf_hash_staged": (_I, [_I64]),
    "gdf_hash_table_bytes": (_I64, [_I, _I64]),
    "gdf_hash_build": (_I, [_I, _P, _P, _P, _I64, _P, _I64, _P, _P]),
    "gdf_hash_probe": (_I, [_I, _P, _P, _P, _I64, _P, _I64, _P, _P, _I64,
                            _P, _P]),
})
lib = KERNELS.load
build = KERNELS.build
library_path = KERNELS.path
check = KERNELS.check
COUNT_LOCK = threading.Lock()


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
