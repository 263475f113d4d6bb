"""One worker process of a cell over several cards: rank r of W joins the
group (libgdf_tpu_torch.parallel.procs.join, one shard on card r), holds
chunk r of the tables, and runs the window in step with the others. Rank 0
prints the result fields after the tag run.WORKER_TAG; gdfbench/run.py
starts the workers and prints the line.

    python3 -m gdfbench.worker --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> --coordinator <host:port> --rank <r> --procs <W>
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from gdfbench import spec  # noqa: E402
from gdfbench.harness import Group, run_mesh  # noqa: E402


def parse_worker(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--procs", type=int, required=True)
    return ap.parse_args(argv)


class ProcessGroup(Group):
    """This process's place in the torch.distributed group: gathers and the
    window's steps over the group's CPU half (gloo)."""

    def __init__(self, rank: int, size: int):
        self.rank, self.size = rank, size

    def gather(self, obj) -> list:
        import torch.distributed as dist
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def go(self, flag: bool) -> bool:
        """Rank 0's flag, to every rank (and a meeting of all)."""
        import torch
        import torch.distributed as dist
        t = torch.tensor([1.0 if flag else 0.0])
        dist.broadcast(t, src=0)
        return bool(t.item())

    def barrier(self) -> None:
        from libgdf_tpu_torch.parallel.procs import host_barrier
        host_barrier()


def main(argv=None):
    from gdfbench.run import WORKER_TAG
    args = parse_worker(argv)
    cell = spec.cell(spec.load_benchmark(), args.workload)
    from libgdf_tpu_torch.parallel import procs
    mesh = procs.join(args.coordinator, args.procs, args.rank,
                      cell["config"]["shards_per_process"])
    out = run_mesh(cell, args.seed, args.seconds, bool(args.trace), mesh,
                   ProcessGroup(args.rank, args.procs), T0)
    if out is not None:
        print(WORKER_TAG + json.dumps(out), flush=True)
    import torch.distributed as dist
    dist.destroy_process_group()
    sys.stdout.flush()


if __name__ == "__main__":
    main()
