"""libgdf_tpu_torch — the query main path of libgdf_tpu on PyTorch and CUDA.

The port of `libgdf_tpu` (JAX on a TPU) to PyTorch with hand-written
Hopper kernels. The JAX package stays the reference: the same inputs give
the same outputs, row order included. This package imports torch and
numpy, never jax.

Layout (mirrors libgdf_tpu):
  core/         Column/Table dataclasses over tensors, dtypes, errors
  ops/          compare_scalar, filter_table, join, groupby, order_by
  ops/kernels/  the Hopper kernels' wrappers and plain versions
  csrc/         the kernels' CUDA C++ sources (built with nvcc at first use)
  utils/        per-operator metrics
  interop.py    numpy <-> Table
"""
from .core import (Column, DtypeInfo, GDFDtype, GDFError, GDFStatus, Table,
                   TimeUnit)
from . import ops
from .interop import from_numpy, to_numpy

__version__ = "0.1.0"

__all__ = [
    "Column", "Table", "GDFDtype", "TimeUnit", "DtypeInfo", "GDFError",
    "GDFStatus", "ops", "from_numpy", "to_numpy",
]
