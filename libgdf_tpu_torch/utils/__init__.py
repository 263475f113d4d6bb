"""Utilities: tracing (≅ NVTX, src/nvtx_utils.*): the program's spans on
the profiler's clock and the count of its host reads."""
from .tracing import (counters, host_sync, op_range, range_pop, range_push,
                      range_push_hex, reset_counters, span, spanned)

__all__ = ["counters", "host_sync", "op_range", "range_pop", "range_push",
           "range_push_hex", "reset_counters", "span", "spanned"]
