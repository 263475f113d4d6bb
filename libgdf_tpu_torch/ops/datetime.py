"""Datetime field extraction.

≅ libgdf/src/datetimeops.cu: gdf_extract_datetime_{year,month,day,hour,
minute,second} over DATE32 / DATE64 / TIMESTAMP(s|ms|us|ns), output INT16
(datetimeops.cu:62-311 civil-from-days thrust functors, dispatch
:312-565; ABI functions.h:516-521).

Counterpart of `libgdf_tpu/ops/datetime.py`. The civil-from-days
algorithm (Howard Hinnant's public-domain date algorithms, the one the
reference embeds at datetimeops.cu:62-96) runs as branch-free int64 tensor
arithmetic. `//` and `%` on integer tensors floor, so pre-1970 values land
in the right day.
"""
from __future__ import annotations

import torch

from ..core.column import Column
from ..core.dtypes import DtypeInfo, GDFDtype, TimeUnit
from ..core.errors import GDFStatus, require

_SUBDAY_UNITS = {  # ticks per second for each TIMESTAMP unit
    TimeUnit.NONE: 1000,  # TIMESTAMP default is ms (types.h:25)
    TimeUnit.s: 1,
    TimeUnit.ms: 1000,
    TimeUnit.us: 1000000,
    TimeUnit.ns: 1000000000,
}


def _to_days_and_secs(col: Column):
    """Normalize any datetime column to (days since epoch, second of day).
    Floor semantics for negative (pre-1970) values, matching the
    reference's `if (unixTime >= 0) ... else ...` handling
    (datetimeops.cu:81-96)."""
    d = col.info.gdf_dtype
    require(col.info.is_datetime, GDFStatus.GDF_UNSUPPORTED_DTYPE,
            "datetime extract requires DATE32/DATE64/TIMESTAMP")
    if d == GDFDtype.DATE32:
        days = col.data.to(torch.int64)
        secs = torch.zeros_like(days)
        return days, secs
    if d == GDFDtype.DATE64:
        per_sec = 1000
    else:
        per_sec = _SUBDAY_UNITS[col.info.time_unit]
    t = col.data.to(torch.int64)
    total_secs = t // per_sec
    days = total_secs // 86400
    secs = total_secs - days * 86400
    return days, secs


def _civil_from_days(days):
    """days since 1970-01-01 -> (year, month, day). Branch-free vector form
    of the algorithm at datetimeops.cu:62-158."""
    z = days + 719468
    era = z // 146097
    doe = z - era * 146097                                    # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365  # [0, 399]
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)           # [0, 365]
    mp = (5 * doy + 2) // 153                                 # [0, 11]
    day = doy - (153 * mp + 2) // 5 + 1                       # [1, 31]
    month = mp + torch.where(mp < 10, 3, -9)                  # [1, 12]
    year = y + (month <= 2)
    return year, month, day


def _wrap(col: Column, vals) -> Column:
    return Column(data=vals.to(torch.int16), valid=col.valid,
                  info=DtypeInfo(GDFDtype.INT16), name=col.name)


def extract_year(col: Column) -> Column:
    days, _ = _to_days_and_secs(col)
    y, _, _ = _civil_from_days(days)
    return _wrap(col, y)


def extract_month(col: Column) -> Column:
    days, _ = _to_days_and_secs(col)
    _, m, _ = _civil_from_days(days)
    return _wrap(col, m)


def extract_day(col: Column) -> Column:
    days, _ = _to_days_and_secs(col)
    _, _, d = _civil_from_days(days)
    return _wrap(col, d)


def extract_hour(col: Column) -> Column:
    _, secs = _to_days_and_secs(col)
    return _wrap(col, secs // 3600)


def extract_minute(col: Column) -> Column:
    _, secs = _to_days_and_secs(col)
    return _wrap(col, (secs % 3600) // 60)


def extract_second(col: Column) -> Column:
    _, secs = _to_days_and_secs(col)
    return _wrap(col, secs % 60)
