"""libgdf_tpu_torch — libgdf_tpu's single-GPU surface on PyTorch.

The port of `libgdf_tpu` (JAX on a TPU) to PyTorch with hand-written
Hopper kernels. The JAX package stays the reference: the same inputs give
the same outputs, row order included. This package imports torch and
numpy, never jax.

Layout (mirrors libgdf_tpu):
  core/         Column/Table dataclasses over tensors, dtypes, validity,
                errors, Context
  ops/          relational + elementwise operators: filter, join, groupby,
                sorts, hashing, scans, windows, reductions, quantiles,
                unary/binary math, casts, datetime extraction
  ops/kernels/  the Hopper kernels' wrappers and plain versions
  csrc/         the kernels' CUDA C++ sources (built with nvcc at first use)
  io/           CSV ingest, Arrow IPC, CSR conversion
  memory/       the RMM surface: handles over tensors, CSV event log
  native/       ctypes binding to the host CSV scanner (g++ at first use)
  parallel/     mesh of row shards, sharded tables, shuffles, distributed
                operators (in-process threads or torch.distributed)
  compat/       the flat gdf_* / gpu_* / rmm* ABI surface
  utils/        tracing: the operators' spans, the count of host reads
  interop.py    numpy <-> Table

numpy data goes to the card unless the caller passes device="cpu".
"""
from .core import (Column, Context, DtypeInfo, GDFDtype, GDFError, GDFStatus,
                   Method, Table, TimeUnit, column_concat, table_concat)
from . import ops
from .interop import from_numpy, to_numpy

__version__ = "0.1.0"

__all__ = [
    "Column", "Table", "GDFDtype", "TimeUnit", "DtypeInfo", "GDFError",
    "GDFStatus", "Context", "Method", "column_concat", "table_concat",
    "ops", "from_numpy", "to_numpy",
]
