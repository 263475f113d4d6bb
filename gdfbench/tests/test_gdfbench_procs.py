"""The four-card cell's worker processes on the CPU: four processes of a
gloo group, started by the port's launcher as gdfbench/run.py starts its
workers, run the window in step and give rank 0 a correct result."""
import json
import sys

from libgdf_tpu_torch.parallel import procs

from gdfbench import spec

TAG = "RESULT "
WORKER = """
import json, sys, time
from libgdf_tpu_torch.parallel import procs
from gdfbench import harness
from gdfbench.tests._cells import small_cell
from gdfbench.worker import ProcessGroup
coord, rank = sys.argv[1], int(sys.argv[2])
mesh = procs.join(coord, 4, rank, 1, device="cpu")
out = harness.run_mesh(small_cell("tpch_sf40_4card.q3", 0.04), 7, 1.0,
                       False, mesh, ProcessGroup(rank, 4), time.perf_counter())
if out is not None:
    print("RESULT " + json.dumps(out), flush=True)
"""


def test_four_worker_processes_on_the_cpu(monkeypatch):
    monkeypatch.chdir(spec.ROOT)
    outs = procs.start(lambda coord, rank: [sys.executable, "-c", WORKER,
                                            coord, str(rank)], 4, 300)
    lines = [ln for ln in outs[0].splitlines() if ln.startswith(TAG)]
    out = json.loads(lines[-1][len(TAG):])
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["forbidden"] == []
    assert out["device"]["count"] == 4
    for text in outs[1:]:
        assert TAG not in text
