"""I/O & interchange: CSV ingest, Arrow IPC, CSR conversion (SURVEY.md
§2.5)."""
from . import csv, csr, ipc
from .csv import CSVReadArg, read_csv, dtype_from_string
from .csr import CSR, gdf_to_csr
from .ipc import IpcParser, gdf_ipc_parser_open

__all__ = [
    "csv", "csr", "ipc", "CSVReadArg", "read_csv", "dtype_from_string",
    "CSR", "gdf_to_csr", "IpcParser", "gdf_ipc_parser_open",
]
