"""Device memory manager surface (≅ RMM).

≅ reference librmm (libgdf/include/memory.h, src/memory/memory.cpp,
python/librmm_cffi/wrapper.py): pool-or-direct allocation with a CSV
event log of every alloc/realloc/free (RAII `LogIt`, memory.cpp:55-110;
rmmWriteLog/rmmGetLog memory.h:160-184; asserted by test_rmm.py:34-45).

Counterpart of `libgdf_tpu/memory/manager.py`. torch's caching allocator
is the pool: this module does not allocate device memory itself. What the
RMM surface gives its users is kept:

  - alloc/realloc/free manage torch tensors through a registry keyed by
    handle, with the C API's lifecycles. Buffers live on the card; on the
    CPU only where the caller passes `device="cpu"`;
  - every event is timed and logged with the CSV schema the reference
    emits (Event Type,Device ID,Address,Stream,Size (bytes),Free Memory,
    Total Memory,Current Allocs,Start,End,Elapsed);
  - rmmGetInfo and the log's Free / Total columns read
    `torch.cuda.mem_get_info()`.
"""
from __future__ import annotations

import csv
import io
import threading
import time
from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np
import torch

from ..core.column import as_tensor, host_data_device


class RMMError(Exception):
    """≅ librmm_cffi.RMMError (wrapper.py:20-24)."""

    def __init__(self, errcode, msg):
        self.errcode = errcode
        super().__init__(msg)


class rmmError_t(IntEnum):
    """≅ include/memory.h:30-42."""
    RMM_SUCCESS = 0
    RMM_ERROR_CUDA_ERROR = 1
    RMM_ERROR_INVALID_ARGUMENT = 2
    RMM_ERROR_NOT_INITIALIZED = 3
    RMM_ERROR_OUT_OF_MEMORY = 4
    RMM_ERROR_UNKNOWN = 5
    RMM_ERROR_IO = 6


class rmmAllocationMode(IntEnum):
    """≅ include/memory.h:22-28."""
    CudaDefaultAllocation = 0
    PoolAllocation = 1


@dataclass
class rmmOptions_t:
    """≅ include/memory.h:44-50."""
    allocation_mode: rmmAllocationMode = rmmAllocationMode.PoolAllocation
    initial_pool_size: int = 0
    enable_logging: bool = True


@dataclass
class _Allocation:
    array: torch.Tensor
    size: int
    created: float


_LOG_COLUMNS = ["Event Type", "Device ID", "Address", "Stream",
                "Size (bytes)", "Free Memory", "Total Memory",
                "Current Allocs", "Start", "End", "Elapsed"]


@dataclass
class _Manager:
    """≅ Manager/Logger singletons (src/memory/memory_manager.{h,cpp})."""
    initialized: bool = False
    options: rmmOptions_t = field(default_factory=rmmOptions_t)
    allocations: dict = field(default_factory=dict)
    events: list = field(default_factory=list)
    next_handle: int = 1
    base_time: float = 0.0
    lock: threading.Lock = field(default_factory=threading.Lock)


_mgr = _Manager()


def _device_mem_info():
    """(free, total) bytes of the current card; (0, 0) where there is
    none."""
    if not torch.cuda.is_available():
        return 0, 0
    return torch.cuda.mem_get_info()


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _log(event, handle, size, t0, t1):
    if not _mgr.options.enable_logging:
        return
    free, total = _device_mem_info()
    _mgr.events.append({
        "Event Type": event, "Device ID": 0, "Address": hex(handle),
        "Stream": 0, "Size (bytes)": size, "Free Memory": free,
        "Total Memory": total, "Current Allocs": len(_mgr.allocations),
        "Start": round(t0 - _mgr.base_time, 9),
        "End": round(t1 - _mgr.base_time, 9),
        "Elapsed": round(t1 - t0, 9),
    })


# -- C-style API (≅ include/memory.h:65-184) --------------------------------

def rmmInitialize(options: rmmOptions_t | None = None) -> rmmError_t:
    """≅ rmmInitialize (memory.cpp:138-160). Pool mode is advisory:
    torch's caching allocator is the pool; the option is recorded for
    parity."""
    with _mgr.lock:
        _mgr.initialized = True
        _mgr.options = options or rmmOptions_t()
        _mgr.base_time = time.perf_counter()
        _mgr.events.clear()
        _mgr.allocations.clear()
    return rmmError_t.RMM_SUCCESS


def rmmFinalize() -> rmmError_t:
    """≅ rmmFinalize (memory.cpp:162-170)."""
    with _mgr.lock:
        _mgr.initialized = False
        _mgr.allocations.clear()
    return rmmError_t.RMM_SUCCESS


def rmmIsInitialized() -> bool:
    return _mgr.initialized


def _require_init():
    if not _mgr.initialized:
        raise RMMError(rmmError_t.RMM_ERROR_NOT_INITIALIZED,
                       "rmmInitialize() has not been called")


def rmmAlloc(size: int, stream: int = 0, dtype=torch.uint8, device=None):
    """≅ rmmAlloc (memory.h:94, memory.cpp:172-196): returns a handle to a
    zero-initialized buffer of `size` elements (a numpy or torch dtype) on
    the card; raises without CUDA unless device="cpu" is passed."""
    _require_init()
    t0 = time.perf_counter()
    arr = torch.zeros(size, dtype=_torch_dtype(dtype),
                      device=host_data_device(device))
    t1 = time.perf_counter()
    with _mgr.lock:
        h = _mgr.next_handle
        _mgr.next_handle += 1
        _mgr.allocations[h] = _Allocation(arr, size, t1)
        _log("Alloc", h, size, t0, t1)
    return h


def rmmRealloc(handle: int, new_size: int, stream: int = 0):
    """≅ rmmRealloc (memory.h:109): new buffer on the old one's device, old
    contents copied."""
    _require_init()
    with _mgr.lock:
        if handle not in _mgr.allocations:
            raise RMMError(rmmError_t.RMM_ERROR_INVALID_ARGUMENT,
                           f"unknown handle {handle}")
        old = _mgr.allocations[handle]
    t0 = time.perf_counter()
    arr = torch.zeros(new_size, dtype=old.array.dtype,
                      device=old.array.device)
    n = min(old.size, new_size)
    arr[:n] = old.array[:n]
    t1 = time.perf_counter()
    with _mgr.lock:
        _mgr.allocations[handle] = _Allocation(arr, new_size, t1)
        _log("Realloc", handle, new_size, t0, t1)
    return handle


def rmmFree(handle: int, stream: int = 0) -> rmmError_t:
    """≅ rmmFree (memory.h:120)."""
    _require_init()
    t0 = time.perf_counter()
    with _mgr.lock:
        if handle not in _mgr.allocations:
            raise RMMError(rmmError_t.RMM_ERROR_INVALID_ARGUMENT,
                           f"unknown handle {handle}")
        del _mgr.allocations[handle]
        _log("Free", handle, 0, t0, time.perf_counter())
    return rmmError_t.RMM_SUCCESS


def rmmGetArray(handle: int) -> torch.Tensor:
    """Engine-side accessor: the device buffer behind a handle."""
    _require_init()
    return _mgr.allocations[handle].array


def rmmGetAllocationOffset(handle: int, stream: int = 0) -> int:
    """≅ rmmGetAllocationOffset (memory.h:138): offset of an allocation in
    its pool, used for CUDA IPC. A tensor is no sub-allocation of a
    user-visible pool; 0 keeps the call meaningful (whole buffer)."""
    _require_init()
    return 0


def rmmGetInfo(stream: int = 0):
    """≅ rmmGetInfo (memory.h:158): (free, total) device memory."""
    _require_init()
    return _device_mem_info()


def rmmGetErrorString(errcode) -> str:
    """≅ rmmGetErrorString (memory.h:81)."""
    try:
        return rmmError_t(errcode).name
    except ValueError:
        return "RMM_ERROR_UNKNOWN"


def rmmLogSize() -> int:
    """≅ rmmLogSize (memory.h:175)."""
    return len(rmmGetLog())


def rmmGetLog() -> str:
    """≅ rmmGetLog (memory.h:184): the CSV event log as a string."""
    buf = io.StringIO()
    w = csv.DictWriter(buf, fieldnames=_LOG_COLUMNS,
                       lineterminator="\n")
    w.writeheader()
    with _mgr.lock:
        for e in _mgr.events:
            w.writerow(e)
    return buf.getvalue()


def rmmWriteLog(filename: str) -> rmmError_t:
    """≅ rmmWriteLog (memory.h:168)."""
    with open(filename, "w") as f:
        f.write(rmmGetLog())
    return rmmError_t.RMM_SUCCESS


def csv_log() -> str:
    """≅ librmm_cffi wrapper.csv_log (wrapper.py:88-96)."""
    return rmmGetLog()


def device_array_from_handle(handle: int, nelem: int):
    """≅ device_array_from_ptr (wrapper.py:106-124): typed slice of an
    allocation (dtype fixed at rmmAlloc time)."""
    return rmmGetArray(handle)[:nelem]


def to_device(host_array, device=None):
    """≅ wrapper.to_device (wrapper.py:163-176): host -> device buffer (the
    card unless device="cpu"), complete when this returns."""
    _require_init()
    t0 = time.perf_counter()
    arr = as_tensor(host_array, device)
    if arr.is_cuda:
        torch.cuda.synchronize(arr.device)
    t1 = time.perf_counter()
    with _mgr.lock:
        h = _mgr.next_handle
        _mgr.next_handle += 1
        _mgr.allocations[h] = _Allocation(arr, _nbytes(arr), t1)
        _log("Alloc", h, _nbytes(arr), t0, t1)
    return arr


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()
