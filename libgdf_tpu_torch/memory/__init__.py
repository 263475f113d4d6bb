"""Memory manager surface (≅ RMM, SURVEY.md §2.6): allocation API with
CSV event-log telemetry over torch's caching allocator."""
from .manager import (
    RMMError, rmmAllocationMode, rmmError_t, rmmOptions_t,
    rmmAlloc, rmmFinalize, rmmFree, rmmGetAllocationOffset,
    rmmGetArray, rmmGetErrorString, rmmGetInfo, rmmGetLog,
    rmmInitialize, rmmIsInitialized, rmmLogSize, rmmRealloc,
    rmmWriteLog, csv_log, device_array_from_handle, to_device,
)

# pythonic aliases (≅ librmm_cffi wrapper.initialize/finalize)
initialize = rmmInitialize
finalize = rmmFinalize

__all__ = [
    "RMMError", "rmmAllocationMode", "rmmError_t", "rmmOptions_t",
    "rmmAlloc", "rmmFinalize", "rmmFree", "rmmGetAllocationOffset",
    "rmmGetArray", "rmmGetErrorString", "rmmGetInfo", "rmmGetLog",
    "rmmInitialize", "rmmIsInitialized", "rmmLogSize", "rmmRealloc",
    "rmmWriteLog", "csv_log", "device_array_from_handle", "to_device",
    "initialize", "finalize",
]
