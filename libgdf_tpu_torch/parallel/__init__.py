"""Distributed layer: a mesh of row shards, sharded tables, shuffles and
distributed relational operators.

Counterpart of `libgdf_tpu/parallel/`, with the same 23 names, signatures
and defaults; only the mesh objects are torch's (parallel/mesh.py). The
shards run in one process, one thread and one CUDA stream each, on one
card or one card each (`make_mesh(C)` on a node of C cards), or one per
process of a torch.distributed group; the collectives behind both are in
parallel/comm.py.
"""
from .mesh import (
    DEFAULT_AXIS, init_distributed, make_mesh, row_sharding, shard_table,
)
from .shuffle import (
    all_gather_table, dest_sizes, global_partition_histogram,
    required_slot_capacity, shuffle_shard,
)
from .distributed import (
    ShardedTable, broadcast_join, collect, detect_skew, dist_groupby,
    dist_join, dist_join_salted, distribute, exact_groupby_slot_capacity,
    exact_slot_capacity, map_shards, plan_salted_join, SaltedJoinPlan,
)

__all__ = [
    "DEFAULT_AXIS", "init_distributed", "make_mesh", "row_sharding",
    "shard_table", "all_gather_table", "dest_sizes",
    "global_partition_histogram", "required_slot_capacity",
    "shuffle_shard", "ShardedTable", "broadcast_join", "collect",
    "detect_skew", "dist_groupby", "dist_join", "dist_join_salted",
    "plan_salted_join", "SaltedJoinPlan",
    "distribute", "exact_groupby_slot_capacity",
    "exact_slot_capacity", "map_shards",
]
