"""Arrow IPC ingest.

≅ reference gdf_ipc_parser_* C API over class IpcParser (libgdf/src/ipc.cu
:77+): parses an Arrow record-batch stream, emits schema JSON + per-column
layout JSON (data/validity buffer offsets into the blob) so the binding
can view columns zero-copy (:167-200), with Arrow 0.7/0.8 version guards
(:260-290).

Counterpart of `libgdf_tpu/io/ipc.py`: the parse is host-side pyarrow
(imported inside the parser, so the package imports without it); the
columns land on the card as one transfer each, or on the CPU where the
caller passes device="cpu". The JSON surfaces (schema/layout/data offset)
are the reference's. A parser that cannot parse, for want of pyarrow too,
is in its error state (`failed()`, `get_error()`), as the reference's is.
"""
from __future__ import annotations

import json

import numpy as np

from ..core.column import Column
from ..core.errors import GDFStatus, require
from ..core.table import Table


class IpcParser:
    """≅ class IpcParser (src/ipc.cu:77-200)."""

    def __init__(self, schema_bytes: bytes, device=None):
        self._device = device
        self._error = None
        self._schema_json = None
        self._layout_json = None
        self._data = None
        self._data_offset = 0
        self._table = None
        try:
            import pyarrow as pa
            self._pa = pa
            # A standalone schema message or a full stream both work.
            self._schema_bytes = bytes(schema_bytes)
            reader = pa.ipc.open_stream(pa.BufferReader(self._schema_bytes))
            self._schema = reader.schema
            self._schema_json = json.dumps({
                "fields": [{"name": f.name, "type": str(f.type),
                            "nullable": f.nullable}
                           for f in self._schema]})
        except Exception as e:  # noqa: BLE001 — parser surface is error-state
            self._error = str(e)

    # -- record batches ----------------------------------------------------

    def open_recordbatches(self, rb_bytes: bytes) -> None:
        """≅ gdf_ipc_parser_open_recordbatches (ipc.cu:437-447): parse the
        record-batch section (header + body) and compute the column
        layout."""
        if self._error:
            return
        try:
            pa = self._pa
            self._data = bytes(rb_bytes)
            # Zero-copy parse so Arrow buffer addresses resolve to offsets
            # into the record-batch blob — the same per-buffer layout the
            # reference computes from the device-side flatbuffer header
            # (ipc.cu:167-200, jsonify_buffer data/null offset+length).
            blob = pa.py_buffer(self._data)
            message = pa.ipc.read_message(blob)
            batch = pa.ipc.read_record_batch(message, self._schema)
            body = message.body
            # Body offset within the blob (≅ get_data_offset, ipc.cu:162).
            self._data_offset = int(body.address - blob.address)

            def buf_desc(buf):
                if buf is None:
                    return {"length": 0, "offset": 0}
                return {"length": int(buf.size),
                        "offset": int(buf.address - body.address)}

            cols, layout = [], []
            for i, f in enumerate(self._schema):
                arr = batch.column(i)
                np_vals = arr.to_numpy(zero_copy_only=False)
                nulls = np.asarray(arr.is_null())
                if nulls.any():
                    fill = np.zeros((), np_vals.dtype) if \
                        np_vals.dtype.kind != "f" else np.nan
                    np_vals = np.where(nulls, fill, np_vals).astype(
                        np_vals.dtype)
                    col = Column.from_masked(np_vals, nulls, name=f.name,
                                             device=self._device)
                else:
                    col = Column.from_array(np_vals, name=f.name,
                                            device=self._device)
                cols.append(col)
                buffers = arr.buffers()  # primitive layout: [validity, data]
                layout.append({
                    "name": f.name, "length": len(arr),
                    "null_count": int(arr.null_count),
                    "dtype": {"name": str(f.type),
                              "bitwidth": np_vals.dtype.itemsize * 8},
                    "data_buffer": buf_desc(
                        buffers[1] if len(buffers) > 1 else None),
                    "null_buffer": buf_desc(buffers[0]),
                })
            self._table = Table.from_columns(cols)
            self._layout_json = json.dumps({"columns": layout})
        except Exception as e:  # noqa: BLE001
            self._error = str(e)

    # -- introspection (≅ ipc.cu:449-494 C wrappers) -----------------------

    def failed(self) -> bool:
        return self._error is not None

    def get_error(self):
        return self._error

    def get_schema_json(self) -> str:
        return self._schema_json or "{}"

    def get_layout_json(self) -> str:
        return self._layout_json or "{}"

    def get_data(self):
        return self._data

    def get_data_offset(self) -> int:
        return self._data_offset

    def to_table(self) -> Table:
        require(self._table is not None, GDFStatus.GDF_C_ERROR,
                self._error or "no record batches opened")
        return self._table


# -- flat C-style API (≅ functions.h:111-124) -------------------------------

def gdf_ipc_parser_open(schema: bytes, length: int | None = None,
                        device=None):
    """≅ gdf_ipc_parser_open (ipc.cu:428-435)."""
    if length is not None:
        schema = bytes(schema)[:length]
    return IpcParser(schema, device)


def gdf_ipc_parser_open_recordbatches(handle: IpcParser, recordbatches,
                                      length: int | None = None):
    if length is not None:
        recordbatches = bytes(recordbatches)[:length]
    handle.open_recordbatches(recordbatches)


def gdf_ipc_parser_close(handle: IpcParser) -> None:
    return None


def gdf_ipc_parser_failed(handle: IpcParser) -> int:
    return int(handle.failed())


def gdf_ipc_parser_to_json(handle: IpcParser) -> str:
    return json.dumps({"schema": json.loads(handle.get_schema_json()),
                       "layout": json.loads(handle.get_layout_json())})


def gdf_ipc_parser_get_error(handle: IpcParser):
    return handle.get_error()


def gdf_ipc_parser_get_data(handle: IpcParser):
    return handle.get_data()


def gdf_ipc_parser_get_data_offset(handle: IpcParser) -> int:
    return handle.get_data_offset()


def gdf_ipc_parser_get_schema_json(handle: IpcParser) -> str:
    return handle.get_schema_json()


def gdf_ipc_parser_get_layout_json(handle: IpcParser) -> str:
    return handle.get_layout_json()
