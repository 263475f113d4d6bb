"""Error codes and exceptions.

≅ reference `gdf_error` enum (libgdf/include/gdf/cffi/types.h:39-64),
`gdf_error_get_name` (src/errorhandling.cpp:5-34) and the Python-side
`GDFError` translation (python/libgdf_cffi/wrapper.py:7-52).

A framework-free copy of `libgdf_tpu/core/errors.py` (importing that
package would pull in JAX); tests/test_torch_core.py pins the two
together. The engine raises exceptions instead of returning codes, but the
code enum is preserved so a compat layer can expose the exact reference
surface.
"""
from __future__ import annotations

import enum


class GDFStatus(enum.IntEnum):
    """Mirrors types.h:39-64 (values and names)."""

    GDF_SUCCESS = 0
    GDF_CUDA_ERROR = 1               # a failed kernel launch
    GDF_UNSUPPORTED_DTYPE = 2
    GDF_COLUMN_SIZE_MISMATCH = 3
    GDF_COLUMN_SIZE_TOO_BIG = 4
    GDF_DATASET_EMPTY = 5
    GDF_VALIDITY_MISSING = 6
    GDF_VALIDITY_UNSUPPORTED = 7
    GDF_INVALID_API_CALL = 8
    GDF_JOIN_DTYPE_MISMATCH = 9
    GDF_JOIN_TOO_MANY_COLUMNS = 10
    GDF_DTYPE_MISMATCH = 11
    GDF_UNSUPPORTED_METHOD = 12
    GDF_INVALID_AGGREGATOR = 13
    GDF_INVALID_HASH_FUNCTION = 14
    GDF_PARTITION_DTYPE_MISMATCH = 15
    GDF_HASH_TABLE_INSERT_FAILURE = 16
    GDF_UNSUPPORTED_JOIN_TYPE = 17
    GDF_C_ERROR = 18
    GDF_FILE_ERROR = 19
    GDF_MEMORYMANAGER_ERROR = 20
    GDF_UNDEFINED_NVTX_COLOR = 21
    GDF_NULL_NVTX_NAME = 22


class GDFError(Exception):
    """Raised by engine ops; carries a GDFStatus code.

    ≅ python/libgdf_cffi/wrapper.py:20-28 which raises GDFError(errname)."""

    def __init__(self, status: GDFStatus, msg: str = ""):
        self.status = GDFStatus(status)
        super().__init__(f"{self.status.name}{': ' + msg if msg else ''}")


def error_get_name(status) -> str:
    """≅ gdf_error_get_name (src/errorhandling.cpp:5-34)."""
    try:
        return GDFStatus(status).name
    except ValueError:
        return "Unknown error"


def require(cond: bool, status: GDFStatus, msg: str = "") -> None:
    """≅ GDF_REQUIRE macro (include/gdf/errorutils.h:22-29) — host-side
    argument validation (never traced)."""
    if not cond:
        raise GDFError(status, msg)
