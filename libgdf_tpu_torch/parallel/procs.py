"""The processes of a mesh that spans processes: start them, and join one.

A mesh under a torch.distributed group (mesh.py, backend process_group)
needs W processes that join one group. `start` runs W copies of a command
on one free local port and waits for them all, killing the others as soon
as one fails or when they outlive a timeout; `join` is what each copy
does first: it joins the group and makes its mesh of W x L shards, with
the current card set to local shard 0's (the one that calls the group).
`host_barrier` is a meeting of every process on the host.
"""
from __future__ import annotations

import datetime
import socket
import subprocess
import tempfile
import time
from typing import Callable

import torch

from .comm import COLLECTIVE_TIMEOUT
from .mesh import Mesh, init_distributed, make_mesh


def free_port() -> int:
    """A TCP port of this host that no socket holds now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(command: Callable[[str, int], list], procs: int,
          timeout: float) -> list:
    """Run the argv `command(coordinator, rank)` for each rank of `procs`
    processes, the coordinator "127.0.0.1:<a free port>"; returns each
    one's output (stdout and stderr together), rank by rank. As soon as
    one exits non-zero, or when they outlive `timeout` seconds, the others
    are killed and RuntimeError names every process that did not exit 0,
    with the end of its output."""
    coord = f"127.0.0.1:{free_port()}"
    logs = [tempfile.TemporaryFile("w+") for _ in range(procs)]
    ps = [subprocess.Popen(command(coord, r), stdout=logs[r],
                           stderr=subprocess.STDOUT, text=True)
          for r in range(procs)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in ps):
            if time.monotonic() > deadline or any(
                    p.poll() not in (None, 0) for p in ps):
                break
            time.sleep(0.1)
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    bad = [r for r, p in enumerate(ps) if p.returncode != 0]
    if bad:
        raise RuntimeError("".join(
            f"process {r} of {procs} exited {ps[r].returncode} (killed if "
            f"another failed or after {timeout} s):\n{outs[r][-3000:]}\n"
            for r in bad))
    return outs


def join(coordinator: str, procs: int, rank: int, local: int,
         device=None) -> Mesh:
    """Join the group of `procs` processes at `coordinator` as `rank` and
    return make_mesh(procs * local, device=device): L = `local` shards in
    this process. init_distributed is a no-op for one process, as the JAX
    package's is; here one process joins a one-rank group of its own, so
    that its collectives still go through the group (gloo, and NCCL for
    a mesh on the card). On a card, the current device becomes local
    shard 0's, so that nothing of the group's falls back to guessing a
    card from the rank."""
    import torch.distributed as dist
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if procs == 1:
        dist.init_process_group(
            "gloo" if on_cpu else "cpu:gloo,cuda:nccl",
            init_method=f"tcp://{coordinator}", world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
    else:
        init_distributed(coordinator, procs, rank)
    mesh = make_mesh(procs * local, device=device)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    return mesh


def host_barrier() -> None:
    """Every process of the group meets, on the host (a gloo all-reduce of
    a CPU tensor: dist.barrier() guesses a card under NCCL)."""
    import torch.distributed as dist
    dist.all_reduce(torch.zeros(1))
