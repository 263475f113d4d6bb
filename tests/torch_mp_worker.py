"""One of N processes of a torch.distributed group on the CPU (gloo), one
shard each. Run by tests/test_torch_multiprocess.py:

    python tests/torch_mp_worker.py HOST:PORT NUM_PROCESSES PROCESS_ID

Every process builds the same table from one seed, keeps its own shard
(distribute_global), and runs dist_groupby sum + count over the group. A
process cannot collect() remote shards, so the result is checked by sums
over all shards (all-reduced) against a numpy oracle; so are a shuffle,
a broadcast and a salted join against a dimension table. Exit 0 and
"proc <id>: OK" mean this process's view agrees. Imports no jax.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from libgdf_tpu_torch import Table  # noqa: E402
from libgdf_tpu_torch import parallel as par  # noqa: E402
from libgdf_tpu_torch.parallel.distributed import distribute_global  # noqa

coordinator, num_procs, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
par.init_distributed(coordinator, num_procs, pid)
mesh = par.make_mesh(device="cpu")
assert (mesh.size, mesh.backend, mesh.local_ranks) == (
    num_procs, "process_group", (pid,)), mesh

n = 4096
rng = np.random.default_rng(7)  # the same data in every process
k = rng.integers(0, 300, n).astype(np.int64)
v = rng.standard_normal(n)

st = distribute_global(Table.from_dict({"k": k, "v": v}, device="cpu"), mesh)
assert len(st.shards) == 1 and int(st.total_rows()) == n
out = par.dist_groupby(mesh, st, ["k"], [("v", "sum", "s"), ("v", "count",
                                                            "c")])
shard = out.shards[0]
live = int(out.counts[pid])
got = torch.tensor([shard["s"].data[:live].sum().item(),
                    float(shard["c"].data[:live].sum()), float(live),
                    float(shard["k"].data[:live].sum())],
                   dtype=torch.float64)
dist.all_reduce(got)
assert int(out.total_rows()) == int(got[2])

keys, inv = np.unique(k, return_inverse=True)
sums = np.bincount(inv, weights=v)
np.testing.assert_allclose(got[0].item(), sums.sum(), rtol=1e-9)
assert got[1].item() == n
assert got[2].item() == len(keys)
assert got[3].item() == keys.sum()
# every fact row meets one dimension row: by shuffle and by broadcast
dim = distribute_global(Table.from_dict(
    {"k": np.arange(300, dtype=np.int64), "w": np.arange(300.0)},
    device="cpu"), mesh)
for joined in (par.dist_join(mesh, st, dim, ["k"], ["k"]),
               par.broadcast_join(mesh, st, dim, ["k"], ["k"]),
               par.dist_join_salted(mesh, st, dim, ["k"], ["k"],
                                    num_bins=64, threshold=3.0)):
    assert int(joined.total_rows()) == n
    j = joined.shards[0]
    live = int(joined.counts[pid])
    w = torch.tensor([float(j["w"].data[:live].sum())], dtype=torch.float64)
    dist.all_reduce(w)
    assert w.item() == float(k.sum())
assert "jax" not in sys.modules
dist.barrier()
dist.destroy_process_group()
print(f"proc {pid}: OK ({len(keys)} groups over {num_procs} processes)")
