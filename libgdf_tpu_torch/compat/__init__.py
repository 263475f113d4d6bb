"""Flat gdf_* ABI-parity surface (≅ libgdf_cffi: every entry point of
include/gdf/cffi/functions.h as a Python callable over the ops layer)."""
from . import gdf

__all__ = ["gdf"]
