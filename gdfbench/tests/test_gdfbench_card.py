"""On the card: each cell's command prints a correct result line, and the
control fails at the cell's own size. Skips without enough cards (decided
inside each test)."""
import json
import subprocess
import sys

import pytest
import torch

from gdfbench import control, spec

BENCH = spec.load_benchmark()


def need_cards(n):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA device(s)")


@pytest.mark.cuda
@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(w, trace):
    need_cards(w["chips"])
    res = subprocess.run(
        [sys.executable, "-m", "gdfbench.run", "--workload", w["name"],
         "--seed", str(2 ** 31 + 3), "--seconds", "3", "--trace",
         str(trace)], capture_output=True, text=True, cwd=spec.ROOT,
        timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == w["chips"]
    cell = spec.cell(BENCH, w["name"])
    want = cell["per_layer"] if trace else cell["end_to_end"]
    assert set(out["metrics"]) == {m["name"] for m in want}


@pytest.mark.cuda
@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_control_fails_at_the_cell_size(w):
    need_cards(1)
    cell = spec.cell(BENCH, w["name"])
    out = control.control(cell, 2 ** 31 + 4, torch.device("cuda:0"))
    assert not out["correct"], out
