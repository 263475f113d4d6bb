"""Operator-scoped tracing ranges.

Counterpart of `libgdf_tpu/utils/tracing.py` (≅ the reference's NVTX
layer: gdf_nvtx_range_push[_hex]/pop, functions.h:18-52, src/
nvtx_utils.cpp:19-76, and the PUSH_RANGE/POP_RANGE macros with their
per-operator colors, src/nvtx_utils.h:17-66).

A range is a label, not compute. Every range is a
`torch.profiler.record_function`, so it shows in a torch.profiler trace
on any device; where CUDA is available it is an NVTX range as well, for
tools that read NVTX. Colors are kept as labels.
"""
from __future__ import annotations

import contextlib
import threading

import torch

# ≅ gdf_color (types.h:140-150): named colors kept as labels.
GDF_GREEN = "green"
GDF_BLUE = "blue"
GDF_YELLOW = "yellow"
GDF_PURPLE = "purple"
GDF_CYAN = "cyan"
GDF_RED = "red"
GDF_WHITE = "white"
GDF_DARK_GREEN = "dark_green"
GDF_ORANGE = "orange"

_stack = threading.local()


def _ranges():
    if not hasattr(_stack, "r"):
        _stack.r = []
    return _stack.r


def range_push(name: str, color: str | int = GDF_GREEN) -> None:
    """≅ gdf_nvtx_range_push (src/nvtx_utils.cpp:19-40)."""
    ann = torch.profiler.record_function(str(name))
    ann.__enter__()
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(str(name))
    _ranges().append((ann, nvtx))


def range_push_hex(name: str, color: int = 0) -> None:
    """≅ gdf_nvtx_range_push_hex (src/nvtx_utils.cpp:42-58)."""
    range_push(name, color)


def range_pop() -> None:
    """≅ gdf_nvtx_range_pop (src/nvtx_utils.cpp:60-76); a pop with no open
    range does nothing."""
    r = _ranges()
    if r:
        ann, nvtx = r.pop()
        if nvtx:
            torch.cuda.nvtx.range_pop()
        ann.__exit__(None, None, None)


@contextlib.contextmanager
def op_range(name: str, color: str = GDF_GREEN):
    """Internal PUSH_RANGE/POP_RANGE analogue (src/nvtx_utils.h:36-66):
    wraps an operator body in one range."""
    range_push(name, color)
    try:
        yield
    finally:
        range_pop()
