from . import compaction, elementwise, engine, hashing, kernels, quantiles
from . import reductions, scan, sort, sorted_search, window
from . import groupby as groupby_mod
from . import join as join_mod
from .compaction import apply_stencil, compact_table, filter_table
from .elementwise import compare, compare_scalar
from .groupby import groupby
from .hashing import (fnv1a_64_columns, hash_columns, hash_combine,
                      hash_partition, hash_table_rows, murmur3_32,
                      partition_ids, partition_sizes)
from .join import (full_join, inner_join, join, join_indices, left_join,
                   lex_searchsorted)
from .quantiles import quantile_approx, quantile_exact
from .reductions import max, min, product, reduce, sum, sum_of_squares
from .scan import prefixsum
from .sort import order_by, radix_decode, radix_encode, sort_table
from .window import window_function

__all__ = [
    "compaction", "elementwise", "engine", "hashing", "kernels",
    "quantiles", "reductions", "scan", "sort", "sorted_search", "window",
    "groupby_mod", "join_mod",
    "apply_stencil", "compact_table", "filter_table",
    "compare", "compare_scalar",
    "groupby", "join", "join_indices", "inner_join", "left_join",
    "full_join", "lex_searchsorted", "order_by", "sort_table",
    "radix_encode", "radix_decode",
    "murmur3_32", "fnv1a_64_columns", "hash_combine", "hash_columns",
    "hash_table_rows", "hash_partition", "partition_ids", "partition_sizes",
    "reduce", "sum", "min", "max", "product", "sum_of_squares",
    "prefixsum", "quantile_exact", "quantile_approx", "window_function",
]
