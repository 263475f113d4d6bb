from . import compaction, elementwise, engine, kernels, sort
from . import groupby as groupby_mod
from . import join as join_mod
from .compaction import apply_stencil, compact_table, filter_table
from .elementwise import compare, compare_scalar
from .groupby import groupby
from .join import full_join, inner_join, join, join_indices, left_join
from .sort import order_by, radix_decode, radix_encode, sort_table

__all__ = [
    "compaction", "elementwise", "engine", "kernels", "sort",
    "groupby_mod", "join_mod",
    "apply_stencil", "compact_table", "filter_table",
    "compare", "compare_scalar",
    "groupby", "join", "join_indices", "inner_join", "left_join",
    "full_join", "order_by", "sort_table", "radix_encode", "radix_decode",
]
