"""The least time the card could take for an operator's logical work.

Bytes are counted from shapes and counted rows, the same whatever
implements the operator: each input column read once and each output row
written once. Intermediates (a stencil, a permutation) are not counted.
The peak is NVIDIA's data sheet for the H100 SXM at its full power limit
of 700 W; the harness prints the card's name and power limit beside it.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, 80 GB HBM3, at 700 W
PEAK_SOURCE = "NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3 at 700 W"


def filter_bytes(rows_in: int, read_itemsizes, kept: int,
                 write_itemsizes) -> int:
    """A filter's logical bytes: `rows_in` rows of every column it reads
    (the predicate's columns and those it keeps), and `kept` rows of every
    column it keeps."""
    return int(rows_in) * sum(read_itemsizes) + \
        int(kept) * sum(write_itemsizes)


def bound_seconds(nbytes: int) -> float:
    """Seconds to move `nbytes` at the card's peak memory rate."""
    return nbytes / HBM_BYTES_PER_S
