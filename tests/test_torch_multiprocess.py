"""The port's distributed layer across processes: 2 torch.distributed
processes on gloo, one shard each, run tests/torch_mp_worker.py
(distribute_global -> dist_groupby, and three joins, checked by
all-reduced sums against a numpy oracle). The port's form of
tests/test_multiprocess.py."""
import os
import socket
import subprocess
import sys


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_dist_groupby():
    coord = f"127.0.0.1:{_free_port()}"
    worker = os.path.join(os.path.dirname(__file__), "torch_mp_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, coord, "2", str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i}: OK" in out, out[-1500:]
