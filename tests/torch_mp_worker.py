"""One of N processes of a torch.distributed group. Two forms:

    python tests/torch_mp_worker.py HOST:PORT NUM_PROCESSES PROCESS_ID
    python tests/torch_mp_worker.py HOST:PORT NUM_PROCESSES PROCESS_ID \\
        --local-shards L --out DIR [--device cuda]

The first (tests/test_torch_multiprocess.py, gloo on the CPU): one shard
a process. Every process builds the same table from one seed, keeps its
own shard (distribute_global), and runs dist_groupby sum + count over the
group. A process cannot collect() remote shards, so the result is checked
by sums over all shards (all-reduced) against a numpy oracle; so are a
shuffle, a broadcast and a salted join against a dimension table.

The second: a mesh of NUM_PROCESSES x L shards, make_mesh(W * L), L in
each process, on the CPU (gloo) or on the cards (NCCL; shard s on
cuda:(s % C)). The tables of `mixed_data` (an int64 and an int16 key,
int16 and float64 values, a float64 column with nulls) are built on the
CPU in every process and distributed with distribute_global; `run_ops`
runs dist_groupby keyed on each key, dist_join, broadcast_join and
dist_join_salted. Each local shard's live rows go to DIR/<op>.<shard>.npz,
which the calling test holds shard by shard to an in-process mesh of
W x L shards and to libgdf_tpu; here the results' sums are all-reduced
and held to a numpy oracle, and collect() must raise where a process
holds only some of the shards. The group is joined, and the mesh
made, by libgdf_tpu_torch.parallel.procs.join (with one process, a
one-rank group of its own, so the collectives still go through it).

Exit 0 and "proc <id>: OK" mean this process's view agrees. Imports no
jax.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from libgdf_tpu_torch import GDFError, GDFStatus, Table  # noqa: E402
from libgdf_tpu_torch import parallel as par  # noqa: E402
from libgdf_tpu_torch.parallel import procs as par_procs  # noqa: E402
from libgdf_tpu_torch.parallel.distributed import distribute_global  # noqa

NKEYS = 300
OPS = ("groupby_k", "groupby_h", "join", "broadcast", "salted")
GROUPBY_K = [("w", "sum", "s"), ("w", "max", "m"), ("v", "sum", "vs"),
             ("v", "count", "c")]
GROUPBY_H = [("w", "sum", "s"), ("w", "min", "m")]


def mixed_data(n=4096, seed=11):
    """(fact, fact nulls, dimension) as numpy: Zipf(1.3) int64 keys k (hot
    keys for the salted join), an int16 key h, an int16 value w over its
    whole range (group sums wrap), a float64 value v with 10% nulls (each a
    multiple of 1/4, so every sum of them is exact in any order); a
    dimension of the NKEYS keys with an int16 payload x."""
    rng = np.random.default_rng(seed)
    fact = {"k": (rng.zipf(1.3, n) % NKEYS).astype(np.int64),
            "h": rng.integers(-200, 200, n).astype(np.int16),
            "w": rng.integers(-32768, 32768, n).astype(np.int16),
            "v": np.round(rng.standard_normal(n) * 4) / 4}
    nulls = {"v": rng.random(n) < 0.1}
    dim = {"k": np.arange(NKEYS, dtype=np.int64),
           "x": rng.integers(-32768, 32768, NKEYS).astype(np.int16)}
    return fact, nulls, dim


def run_ops(mesh, fact, dim) -> dict:
    """Every operator of the layer over the distributed tables."""
    return {
        "groupby_k": par.dist_groupby(mesh, fact, ["k"], GROUPBY_K),
        "groupby_h": par.dist_groupby(mesh, fact, ["h"], GROUPBY_H),
        # a hot key's rows all meet on one shard
        "join": par.dist_join(mesh, fact, dim, ["k"], ["k"],
                              out_capacity_per_shard=fact.capacity),
        "broadcast": par.broadcast_join(mesh, fact, dim, ["k"], ["k"]),
        "salted": par.dist_join_salted(mesh, fact, dim, ["k"], ["k"],
                                       num_bins=64, threshold=3.0),
    }


def save_shards(st, mesh, op: str, out: str) -> None:
    """Each local shard's live rows, names, capacity and count."""
    for i, s in enumerate(mesh.local_ranks):
        slab, k = st.shards[i], int(st.counts[s])
        arrays = {"names": np.array(slab.names),
                  "capacity": slab.capacity, "count": k}
        for name, c in zip(slab.names, slab.columns):
            arrays[f"d_{name}"] = c.data[:k].cpu().numpy()
            if c.valid is not None:
                arrays[f"v_{name}"] = c.valid[:k].cpu().numpy()
        np.savez(os.path.join(out, f"{op}.{s}.npz"), **arrays)


def load_shards(out: str, op: str, size: int):
    """The ShardedTable of `op` that the workers saved, every shard of a
    mesh of `size`, on the CPU."""
    shards, counts = [], []
    for s in range(size):
        z = np.load(os.path.join(out, f"{op}.{s}.npz"))
        cap, k = int(z["capacity"]), int(z["count"])
        cols, nulls = {}, {}
        for name in z["names"].tolist():
            live = z[f"d_{name}"]
            cols[name] = np.zeros(cap, live.dtype)
            cols[name][:k] = live
            if f"v_{name}" in z:
                nulls[name] = np.ones(cap, bool)
                nulls[name][:k] = ~z[f"v_{name}"]
        shards.append(Table.from_dict(cols, nulls or None, device="cpu"))
        counts.append(k)
    return par.ShardedTable(shards=tuple(shards),
                            counts=torch.tensor(counts, dtype=torch.int32))


def run_workers(procs: int, *args: str, timeout: float = 180) -> list:
    """Start `procs` workers of a fresh group (parallel/procs.py::start),
    each with `args`; returns their outputs. Raises (after killing the
    others) if one exits non-zero, does not end within `timeout` s or does
    not say OK."""
    outs = par_procs.start(lambda coord, i: [
        sys.executable, __file__, coord, str(procs), str(i), *args],
        procs, timeout)
    for i, out in enumerate(outs):
        if f"proc {i}: OK" not in out:
            raise RuntimeError(f"worker {i} said no OK:\n{out[-3000:]}")
    return outs


def _live_sum(st, mesh, col: str) -> int:
    return sum(int(st.shards[i][col].data[:int(st.counts[s])].long().sum())
               for i, s in enumerate(mesh.local_ranks))


def check_against_numpy(res, mesh, fact, nulls, dim, device) -> None:
    """Sums over every shard, all-reduced, against numpy."""
    k, h, w = fact["k"], fact["h"], fact["w"].astype(np.int64)
    keys, inv = np.unique(k, return_inverse=True)
    sums = np.bincount(inv, weights=w).astype(np.int64).astype(np.int16)
    hkeys, hinv = np.unique(h, return_inverse=True)
    hsums = np.bincount(hinv, weights=w).astype(np.int64).astype(np.int16)
    wmax = np.full(len(keys), -32768, np.int64)
    np.maximum.at(wmax, inv, w)
    want = {
        ("groupby_k", "s"): int(sums.astype(np.int64).sum()),
        ("groupby_k", "m"): int(wmax.sum()),
        ("groupby_k", "k"): int(keys.sum()),
        ("groupby_k", "c"): int((~nulls["v"]).sum()),
        ("groupby_h", "s"): int(hsums.astype(np.int64).sum()),
        ("groupby_h", "h"): int(hkeys.astype(np.int64).sum()),
    }
    for op in ("join", "broadcast", "salted"):
        want[op, "x"] = int(dim["x"].astype(np.int64)[k].sum())
        want[op, "w"] = int(w.sum())
    got = torch.tensor([_live_sum(res[op], mesh, col) for op, col in want],
                       dtype=torch.int64, device=device)
    dist.all_reduce(got)
    for (op, col), g, expect in zip(want, got.tolist(), want.values()):
        assert g == expect, (op, col, g, expect)
    rows = torch.tensor([int(res[op].total_rows()) for op in OPS],
                        dtype=torch.int64)
    assert rows.tolist() == [len(keys), len(hkeys)] + [len(k)] * 3, rows


def shards_form(args) -> str:
    """The second form; returns what this process checked."""
    procs, pid, local = args.num_processes, args.process_id, \
        args.local_shards
    mesh = par_procs.join(args.coordinator, procs, pid, local,
                          device="cpu" if args.device == "cpu" else None)
    want_devs = [torch.device("cpu") if args.device == "cpu" else
                 torch.device("cuda", s % torch.cuda.device_count())
                 for s in range(pid * local, (pid + 1) * local)]
    assert (mesh.size, mesh.backend, mesh.local_ranks, list(mesh.devices)) \
        == (procs * local, "process_group",
            tuple(range(pid * local, (pid + 1) * local)), want_devs), mesh
    fact, nulls, dim = mixed_data(args.rows)
    f = distribute_global(Table.from_dict(fact, nulls, device="cpu"), mesh)
    d = distribute_global(Table.from_dict(dim, device="cpu"), mesh)
    assert [t.device for t in f.shards] == want_devs
    res = run_ops(mesh, f, d)
    for op, st in res.items():
        assert len(st.shards) == local and st.counts.shape == (mesh.size,)
        save_shards(st, mesh, op, args.out)
    check_against_numpy(res, mesh, fact, nulls, dim, mesh.device)
    try:
        par.collect(res["join"])
        assert procs == 1, "collect() of shards held elsewhere"
    except GDFError as e:
        assert procs > 1 and e.status == GDFStatus.GDF_INVALID_API_CALL, e
    return f"{len(OPS)} operators over {procs} x {local} shards"


def one_shard_form(coordinator, num_procs, pid) -> str:
    """The first form."""
    par.init_distributed(coordinator, num_procs, pid)
    mesh = par.make_mesh(device="cpu")
    assert (mesh.size, mesh.backend, mesh.local_ranks) == (
        num_procs, "process_group", (pid,)), mesh

    n = 4096
    rng = np.random.default_rng(7)  # the same data in every process
    k = rng.integers(0, 300, n).astype(np.int64)
    v = rng.standard_normal(n)

    st = distribute_global(Table.from_dict({"k": k, "v": v}, device="cpu"),
                           mesh)
    assert len(st.shards) == 1 and int(st.total_rows()) == n
    out = par.dist_groupby(mesh, st, ["k"], [("v", "sum", "s"),
                                             ("v", "count", "c")])
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
        w = torch.tensor([float(j["w"].data[:live].sum())],
                         dtype=torch.float64)
        dist.all_reduce(w)
        assert w.item() == float(k.sum())
    return f"{len(keys)} groups over {num_procs} processes"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("coordinator")
    ap.add_argument("num_processes", type=int)
    ap.add_argument("process_id", type=int)
    ap.add_argument("--local-shards", type=int)
    ap.add_argument("--out")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--rows", type=int, default=4096)
    args = ap.parse_args(argv)
    if args.local_shards is None:
        what = one_shard_form(args.coordinator, args.num_processes,
                              args.process_id)
    else:
        what = shards_form(args)
    assert "jax" not in sys.modules
    par_procs.host_barrier()
    dist.destroy_process_group()
    print(f"proc {args.process_id}: OK ({what})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
