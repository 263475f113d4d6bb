from . import compaction, datetime, elementwise, engine, hashing, kernels
from . import quantiles, reductions, scan, sort, sorted_search, window
from . import groupby as groupby_mod
from . import join as join_mod
from .compaction import apply_stencil, compact_table, filter_table
from .datetime import (extract_day, extract_hour, extract_minute,
                       extract_month, extract_second, extract_year)
from .elementwise import (
    add, sub, mul, div, floordiv, gt, ge, lt, le, eq, ne,
    bitwise_and, bitwise_or, bitwise_xor,
    sin, cos, tan, asin, acos, atan, exp, log, sqrt, ceil, floor,
    cast, unary_op, binary_op, compare, compare_scalar,
)
from .groupby import (count_distinct_keys, group_by_avg, group_by_count,
                      group_by_max, group_by_min, group_by_sum, groupby)
from .hashing import (fnv1a_64_columns, hash_columns, hash_combine,
                      hash_partition, hash_table_rows, murmur3_32,
                      partition_ids, partition_sizes)
from .join import (full_join, inner_join, join, join_indices, left_join,
                   lex_searchsorted)
from .quantiles import quantile_approx, quantile_exact
from .reductions import max, min, product, reduce, sum, sum_of_squares
from .scan import prefixsum
from .sort import (order_by, radix_decode, radix_encode, radixsort,
                   segmented_radixsort, sort_table)
from .window import window_function

__all__ = [
    "compaction", "datetime", "elementwise", "engine", "hashing", "kernels",
    "quantiles", "reductions", "scan", "sort", "sorted_search", "window",
    "groupby_mod", "join_mod",
    "apply_stencil", "compact_table", "filter_table",
    "add", "sub", "mul", "div", "floordiv", "gt", "ge", "lt", "le", "eq",
    "ne", "bitwise_and", "bitwise_or", "bitwise_xor",
    "sin", "cos", "tan", "asin", "acos", "atan", "exp", "log", "sqrt",
    "ceil", "floor", "cast", "unary_op", "binary_op",
    "compare", "compare_scalar",
    "extract_year", "extract_month", "extract_day", "extract_hour",
    "extract_minute", "extract_second",
    "groupby", "count_distinct_keys", "group_by_sum", "group_by_min",
    "group_by_max", "group_by_avg", "group_by_count",
    "join", "join_indices", "inner_join", "left_join",
    "full_join", "lex_searchsorted", "order_by", "sort_table",
    "radixsort", "segmented_radixsort", "radix_encode", "radix_decode",
    "murmur3_32", "fnv1a_64_columns", "hash_combine", "hash_columns",
    "hash_table_rows", "hash_partition", "partition_ids", "partition_sizes",
    "reduce", "sum", "min", "max", "product", "sum_of_squares",
    "prefixsum", "quantile_exact", "quantile_approx", "window_function",
]
