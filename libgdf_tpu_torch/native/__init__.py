"""ctypes binding to the native host CSV scanner (native/csvparse.cpp).

Counterpart of `libgdf_tpu/native/__init__.py` (≅ the reference's
dlopen-based binding layer, python/libgdf_cffi/__init__.py:14-31). The
scanner is host code. It is built from the checkout's `native/csvparse.cpp`
with g++ at first use, into `build/native/` at the root of the checkout,
keyed by a hash of the source, and loaded from there. It is optional:
where there is no compiler or no source, `csv_scan_available()` is False
and io/csv.py scans in Python.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "csvparse.cpp"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_LOCK = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libgdf_native_{h.hexdigest()[:16]}.so"


def _build():
    """Path of the scanner library, compiled unless it exists already; None
    where the source or the compiler is missing or the build fails."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not SOURCE.exists() or not cxx:
        return None
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    return out


def _load():
    global _lib, _tried
    with _LOCK:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.gdf_csv_open.restype = ctypes.c_void_p
        lib.gdf_csv_open.argtypes = [ctypes.c_char_p, ctypes.c_char,
                                     ctypes.c_char, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int]
        lib.gdf_csv_nrows.restype = ctypes.c_longlong
        lib.gdf_csv_nrows.argtypes = [ctypes.c_void_p]
        lib.gdf_csv_parse_column.restype = ctypes.c_int
        lib.gdf_csv_parse_column.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_void_p,
                                             ctypes.c_void_p]
        lib.gdf_csv_field.restype = ctypes.c_longlong
        lib.gdf_csv_field.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                      ctypes.c_int, ctypes.c_char_p,
                                      ctypes.c_longlong]
        lib.gdf_csv_close.restype = None
        lib.gdf_csv_close.argtypes = [ctypes.c_void_p]
        lib.gdf_csv_column_text.restype = ctypes.c_longlong
        lib.gdf_csv_column_text.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_void_p,
                                            ctypes.c_void_p]
        _lib = lib
        return lib


# dtype codes shared with native/csvparse.cpp
DTYPE_CODES = {np.dtype(np.int8): 1, np.dtype(np.int16): 2,
               np.dtype(np.int32): 3, np.dtype(np.int64): 4,
               np.dtype(np.float32): 5, np.dtype(np.float64): 6}


def csv_scan_available() -> bool:
    return _load() is not None


class NativeCsv:
    """One opened CSV file (mmap + record index held in C++)."""

    def __init__(self, path: str, delimiter: str = ",",
                 lineterminator: str = "\n", skiprows: int = 0,
                 skipfooter: int = 0, skipinitialspace: bool = False):
        lib = _load()
        if lib is None:
            raise ImportError("native CSV scanner unavailable")
        self._lib = lib
        self._h = lib.gdf_csv_open(path.encode(), delimiter.encode(),
                                   lineterminator.encode(), skiprows,
                                   skipfooter, int(skipinitialspace))
        if not self._h:
            raise OSError(f"cannot open {path}")

    @property
    def nrows(self) -> int:
        return int(self._lib.gdf_csv_nrows(self._h))

    def parse_numeric(self, col: int, dtype):
        """(values, null_mask) for a numeric column."""
        dt = np.dtype(dtype)
        n = self.nrows
        out = np.empty(n, dt)
        valid = np.empty(n, np.uint8)
        rc = self._lib.gdf_csv_parse_column(
            self._h, col, DTYPE_CODES[dt],
            out.ctypes.data_as(ctypes.c_void_p),
            valid.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise ValueError(f"unsupported native dtype {dt}")
        return out, valid == 0

    def field(self, row: int, col: int) -> str:
        """Raw text of one field (str/date columns)."""
        cap = 256
        buf = ctypes.create_string_buffer(cap)
        ln = self._lib.gdf_csv_field(self._h, row, col, buf, cap)
        if ln > cap:
            buf = ctypes.create_string_buffer(ln)
            ln = self._lib.gdf_csv_field(self._h, row, col, buf, ln)
        return buf.raw[:ln].decode("utf-8", errors="replace")

    def column_text(self, col: int):
        """All raw field texts of one column.

        One batched C call (offsets + contiguous bytes buffer) instead
        of one ctypes round-trip per field."""
        fn = self._lib.gdf_csv_column_text
        n = self.nrows
        offsets = np.empty(n + 1, np.int64)
        total = fn(self._h, col, offsets.ctypes.data_as(ctypes.c_void_p),
                   None)
        buf = np.empty(max(int(total), 1), np.uint8)
        fn(self._h, col, offsets.ctypes.data_as(ctypes.c_void_p),
           buf.ctypes.data_as(ctypes.c_void_p))
        off = offsets.tolist()          # python ints: fast slicing below
        if not (buf & 0x80).any():      # ASCII: byte offsets == chars
            s = buf.tobytes().decode("ascii")
            return [s[off[i]:off[i + 1]] for i in range(n)]
        mv = memoryview(buf)
        return [str(mv[off[i]:off[i + 1]], "utf-8", "replace")
                for i in range(n)]

    def close(self):
        if self._h:
            self._lib.gdf_csv_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass


def csv_scan_file(path, delimiter, lineterminator, num_cols, skiprows,
                  skipfooter, skipinitialspace):
    """Field matrix via the native scanner (fallback-compatible shape:
    list of rows, each a list of str fields)."""
    f = NativeCsv(path, delimiter, lineterminator, skiprows, skipfooter,
                  skipinitialspace)
    try:
        if f.nrows == 0:
            return []
        cols = [f.column_text(j) for j in range(num_cols)]
        return [list(row) for row in zip(*cols)]
    finally:
        f.close()
