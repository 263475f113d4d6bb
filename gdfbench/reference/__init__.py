"""The plain references: each query's semantics in plain torch, and the
comparison of the program's answers with them.

A module `<query>.py` holds `reference(db, params, dtype)`, the query
worked out from the generated tensors alone, in `dtype` (float64, the
configuration's DECIMAL; float32 for the control), and `readings(got,
want)`, the numbers compared, each against `LIMITS`. Nothing here imports
libgdf_tpu_torch or takes anything that it made.
"""
from __future__ import annotations

import torch


def rel_gap(got, want) -> float:
    """The widest |got - want| / |want| over matching elements (want 0:
    the gap itself)."""
    got = torch.as_tensor(got, dtype=torch.float64)
    want = torch.as_tensor(want, dtype=torch.float64)
    if got.numel() == 0:
        return 0.0
    den = want.abs().clamp(min=torch.finfo(torch.float64).tiny)
    gap = (got - want).abs() / den
    gap = torch.where(want == 0, (got - want).abs(), gap)
    return float(gap.max())


def count_gap(got, want) -> int:
    """|got - want| for counts, or summed over lists of counts."""
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            return max(sum(want), 1)
        return int(sum(abs(int(g) - int(w)) for g, w in zip(got, want)))
    return abs(int(got) - int(want))
