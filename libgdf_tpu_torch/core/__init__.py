from .dtypes import DtypeInfo, GDFDtype, TimeUnit, dtype_from_numpy
from .errors import GDFError, GDFStatus, error_get_name, require
from .column import Column
from .table import Table
from . import bitmask

__all__ = [
    "GDFDtype", "TimeUnit", "DtypeInfo", "dtype_from_numpy",
    "GDFError", "GDFStatus", "error_get_name", "require",
    "Column", "Table", "bitmask",
]
