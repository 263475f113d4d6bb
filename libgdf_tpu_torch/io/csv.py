"""CSV ingest.

≅ reference read_csv (libgdf/src/io/csv/csv-reader.cu:170+, args struct
include/gdf/cffi/io_types.h:26-58): mmap + device byte-scan kernels
(countRecords/storeRecordStart/convertCsvToGdf) producing typed columns
with a validity bit per parsed field.

Counterpart of `libgdf_tpu/io/csv.py`. The scan runs on the host on both
routes: the native C++ parser (native/csvparse.cpp, built at first use by
`libgdf_tpu_torch/native`) when available, else a Python scan; the typed
columns then land on the card, one transfer per column (on the CPU where
the caller passes device="cpu"). `CSVReadArg.scanner` says which ran.
Field → dtype conversions mirror convertStringToDtype (csv-reader.cu:393-412) including "str" →
GDF_CATEGORY (int32 codes) and the date/datetime parser's dayfirst flag
(date-time-parser.cuh:68-119). Empty/unparseable fields clear the row's
validity bit, like the reference's atomic bitmask set (:119-130).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from ..core.column import Column
from ..core.dtypes import GDFDtype, TimeUnit, DtypeInfo
from ..core.errors import GDFError, GDFStatus, require
from ..core.table import Table

# ≅ convertStringToDtype (csv-reader.cu:393-412)
_DTYPE_STRINGS = {
    "str": GDFDtype.CATEGORY,
    "date": GDFDtype.DATE64,
    "date32": GDFDtype.DATE32,
    "date64": GDFDtype.DATE64,
    "timestamp": GDFDtype.TIMESTAMP,
    "float": GDFDtype.FLOAT32,
    "float32": GDFDtype.FLOAT32,
    "float64": GDFDtype.FLOAT64,
    "double": GDFDtype.FLOAT64,
    "int": GDFDtype.INT32,
    "int32": GDFDtype.INT32,
    "int64": GDFDtype.INT64,
    "long": GDFDtype.INT64,
    "int8": GDFDtype.INT8,
    "int16": GDFDtype.INT16,
    "short": GDFDtype.INT16,
}


def dtype_from_string(s: str) -> GDFDtype:
    """≅ convertStringToDtype (csv-reader.cu:393-412)."""
    require(s in _DTYPE_STRINGS, GDFStatus.GDF_UNSUPPORTED_DTYPE, s)
    return _DTYPE_STRINGS[s]


@dataclass
class CSVReadArg:
    """≅ csv_read_arg (io_types.h:26-58), field-for-field."""
    file_path: str = ""
    lineterminator: str = "\n"
    delimiter: str = ","
    delim_whitespace: bool = False
    skipinitialspace: bool = False
    num_cols: int = 0
    names: Sequence[str] = field(default_factory=list)
    dtype: Sequence[str] = field(default_factory=list)
    skiprows: int = 0
    skipfooter: int = 0
    dayfirst: bool = False
    # Out fields (≅ num_cols_out/num_rows_out/data)
    num_cols_out: int = 0
    num_rows_out: int = 0
    data: Optional[list] = None
    scanner: str = ""   # out: "native" or "python", the scan that ran


def _split_records(raw: bytes, arg: CSVReadArg):
    """Record + field split (≅ countRecords/storeRecordStart kernels,
    csv-reader.cu:505-608, done host-side)."""
    text = raw.decode("utf-8", errors="replace")
    term = arg.lineterminator
    lines = text.split(term)
    if lines and lines[-1] == "":
        lines.pop()  # trailing terminator
    if arg.skiprows:
        lines = lines[arg.skiprows:]
    if arg.skipfooter:
        lines = lines[:len(lines) - arg.skipfooter]
    rows = []
    for ln in lines:
        if arg.delim_whitespace:
            fields = ln.split()
        else:
            fields = ln.split(arg.delimiter)
            if arg.skipinitialspace:
                fields = [f.lstrip() for f in fields]
        rows.append(fields)
    return rows


def _parse_column(values, dtype: GDFDtype, dayfirst: bool):
    """One column of raw strings → (np array, null bool mask).

    ≅ convertCsvToGdf's per-field convertStrToValue / parseDateFormat
    (csv-reader.cu:610-760, type_conversion.cuh, date-time-parser.cuh)."""
    n = len(values)
    null = np.zeros(n, bool)

    if dtype == GDFDtype.CATEGORY:
        # "str" columns become int32 dictionary codes (the reference's
        # GDF_CATEGORY is exactly this: hashed/encoded strings).
        stripped = [v.strip() for v in values]
        null = np.asarray([v == "" for v in stripped])
        uniq = sorted({v for v, isnull in zip(stripped, null) if not isnull})
        codes = {v: i for i, v in enumerate(uniq)}
        data = np.asarray([codes.get(v, 0) for v in stripped], np.int32)
        return data, null, uniq

    if dtype in (GDFDtype.DATE32, GDFDtype.DATE64, GDFDtype.TIMESTAMP):
        import pandas as pd
        ser = pd.Series([v.strip() or None for v in values])
        # ISO dates first (dayfirst must not reorder them — matching the
        # reference's parser, which only applies dayfirst to the
        # slash-separated DD/MM forms, date-time-parser.cuh:68-119);
        # remaining fields get the locale-style dayfirst parse.
        parsed = pd.to_datetime(ser, errors="coerce", format="ISO8601")
        rest = parsed.isna() & ser.notna()
        if rest.any():
            retry = pd.to_datetime(ser[rest], errors="coerce",
                                   dayfirst=dayfirst, format="mixed")
            parsed = parsed.copy()
            parsed[rest] = retry
        null = parsed.isna().to_numpy()
        parsed = pd.Series(parsed).astype("datetime64[ns]")
        epoch_ns = parsed.astype("int64").to_numpy()
        epoch_ns = np.where(null, 0, epoch_ns)
        if dtype == GDFDtype.DATE32:
            data = (epoch_ns // 86_400_000_000_000).astype(np.int32)
        else:  # DATE64 / TIMESTAMP(ms)
            data = (epoch_ns // 1_000_000).astype(np.int64)
        return data, null, None

    npdt = {GDFDtype.INT8: np.int8, GDFDtype.INT16: np.int16,
            GDFDtype.INT32: np.int32, GDFDtype.INT64: np.int64,
            GDFDtype.FLOAT32: np.float32,
            GDFDtype.FLOAT64: np.float64}[dtype]
    data = np.zeros(n, npdt)
    for i, v in enumerate(values):
        v = v.strip()
        if not v:
            null[i] = True
            continue
        try:
            data[i] = npdt(float(v)) if npdt in (np.float32, np.float64) \
                else npdt(int(float(v)))
        except (ValueError, OverflowError):
            null[i] = True
    return data, null, None


def read_csv(arg: CSVReadArg, device=None) -> Table:
    """≅ read_csv (io_functions.h; impl csv-reader.cu:170+).

    Fills arg.num_cols_out/num_rows_out/data like the C API and also
    returns the result as a Table (categories dictionaries attached as
    `Table.categories`). The columns go to the card; without CUDA it
    raises unless device="cpu" is passed."""
    require(bool(arg.file_path), GDFStatus.GDF_FILE_ERROR, "no file_path")
    require(len(arg.names) == len(arg.dtype) > 0,
            GDFStatus.GDF_INVALID_API_CALL,
            "names/dtype arrays must be equal length > 0")

    _NUMERIC_NP = {GDFDtype.INT8: np.int8, GDFDtype.INT16: np.int16,
                   GDFDtype.INT32: np.int32, GDFDtype.INT64: np.int64,
                   GDFDtype.FLOAT32: np.float32,
                   GDFDtype.FLOAT64: np.float64}

    native = None
    raw_fields = None
    if not arg.delim_whitespace:
        try:
            # Native route: mmap + multithreaded scan/convert in C++
            # (native/csvparse.cpp).
            from ..native import NativeCsv, csv_scan_available
            if csv_scan_available():
                native = NativeCsv(arg.file_path, arg.delimiter,
                                   arg.lineterminator, arg.skiprows,
                                   arg.skipfooter, arg.skipinitialspace)
        except (ImportError, OSError):
            native = None
    if native is None:
        try:
            with open(arg.file_path, "rb") as f:
                raw = f.read()
        except OSError as e:
            raise GDFError(GDFStatus.GDF_FILE_ERROR, str(e)) from e
        raw_fields = _split_records(raw, arg)

    ncols = len(arg.names)
    cols, cats = [], {}
    for j, (name, dts) in enumerate(zip(arg.names, arg.dtype)):
        dtype = dtype_from_string(dts)
        uniq = None
        if native is not None and dtype in _NUMERIC_NP:
            data, null = native.parse_numeric(j, _NUMERIC_NP[dtype])
        else:
            vals = (native.column_text(j) if native is not None
                    else [r[j] if j < len(r) else "" for r in raw_fields])
            data, null, uniq = _parse_column(vals, dtype, arg.dayfirst)
        col = Column.from_masked(data, null if null.any() else None,
                                 name=name, device=device)
        if dtype in (GDFDtype.DATE32, GDFDtype.DATE64, GDFDtype.TIMESTAMP,
                     GDFDtype.CATEGORY):
            unit = (TimeUnit.ms if dtype in (GDFDtype.DATE64,
                                             GDFDtype.TIMESTAMP)
                    else TimeUnit.NONE)
            col = Column(data=col.data, valid=col.valid,
                         info=DtypeInfo(dtype, unit), name=name)
        cols.append(col)
        if uniq is not None:
            cats[name] = uniq

    t = Table.from_columns(cols)
    object.__setattr__(t, "categories", cats)
    arg.num_cols_out = ncols
    arg.num_rows_out = t.capacity
    arg.data = list(t.columns)
    arg.scanner = "python" if native is None else "native"
    return t
