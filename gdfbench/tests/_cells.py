"""Cells at a scale that a CPU test holds."""
import time

from gdfbench import harness, spec

SEED = 2 ** 31 + 99
# The four-card cell, for the tests of its plan wherever BENCHMARK.json
# does not list it.
FOUR_CARD_CONFIG = {"name": "tpch_sf40_4card",
                    "file": "gdfbench/configs/tpch_sf40_4card.json"}
FOUR_CARD = {"name": "tpch_sf40_4card.q3", "config": "tpch_sf40_4card",
             "traffic": "q3_stream", "chips": 4}


def bench() -> dict:
    b = spec.load_benchmark()
    if FOUR_CARD["name"] not in {w["name"] for w in b["workloads"]}:
        b["configs"].append(FOUR_CARD_CONFIG)
        b["workloads"].append(FOUR_CARD)
    return b


def small_cell(name: str, sf: float) -> dict:
    cell = spec.cell(bench(), name)
    cell["config"]["scale_factor"] = sf
    return cell


def run_cpu(name: str, sf: float, seconds: float = 0.5, trace=False,
            seed=SEED) -> dict:
    """One run of the cell on the CPU, every shard in this process."""
    import torch
    torch.set_num_threads(2)
    cell = small_cell(name, sf)
    t0 = time.perf_counter()
    if cell["workload"]["chips"] == 1:
        return harness.run_single(cell, seed, seconds, trace, "cpu", t0)
    from libgdf_tpu_torch import parallel as par
    mesh = par.make_mesh(cell["config"]["chunks"], device="cpu")
    return harness.run_mesh(cell, seed, seconds, trace, mesh,
                            harness.Group(), t0)
