from .dtypes import (GDFDtype, TimeUnit, DtypeInfo, byte_width,
                     dtype_from_numpy, WindowFunctionType,
                     WindowReductionType)
from .errors import GDFError, GDFStatus, error_get_name, require
from .column import Column, column_concat
from .table import Table, table_concat
from .context import Context, Method, context_view
from . import bitmask

__all__ = [
    "GDFDtype", "TimeUnit", "DtypeInfo", "byte_width", "dtype_from_numpy",
    "WindowFunctionType", "WindowReductionType",
    "GDFError", "GDFStatus", "error_get_name", "require",
    "Column", "column_concat", "Table", "table_concat",
    "Context", "Method", "context_view", "bitmask",
]
