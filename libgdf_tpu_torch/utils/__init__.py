"""Utilities: tracing ranges (≅ NVTX, src/nvtx_utils.*) and per-operator
metrics (≅ RMM's event log, src/memory/memory.cpp:55-110, generalized to
operators)."""
from . import metrics
from .tracing import op_range, range_pop, range_push, range_push_hex

__all__ = ["metrics", "op_range", "range_pop", "range_push",
           "range_push_hex"]
