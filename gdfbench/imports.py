"""The check that nothing the benchmark loads is JAX or the JAX package.

Module names are compared by their top-level name, the part before the
first dot, whole: `libgdf_tpu_torch` (the port) passes, `libgdf_tpu` (the
JAX package) does not. This module imports nothing of its own, so the check
can run before anything else is loaded.
"""
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "libgdf_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in list(names)} & set(FORBIDDEN))
