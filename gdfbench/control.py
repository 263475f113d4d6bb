"""The control of a cell's comparison: the reference put in the program's
place, computed one precision below the configuration's (float32 for its
float64 DECIMAL), has to come out as not correct.

    python3 -m gdfbench.control --workload <cell> --seeds <n,n,...>

For each seed: the cell's tables (every chunk, one after another on one
card), the first `check_queries` parameters of the cell's stream, and for
each the float32 reference's answer compared with the float64 one by the
cell's own readings. Prints one JSON line a seed: each reading's worst
value beside its limit, and whether the control passed (it must not).
The benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from types import SimpleNamespace

import torch

from . import mix as mixes, spec
from .data import tpch
from .harness import checks, verdict


def as_result(ref: dict) -> SimpleNamespace:
    """A reference's answer in the shape of a program's QueryResult."""
    if "groups" in ref:
        return SimpleNamespace(answer={k: v.tolist()
                                       for k, v in ref["top"].items()},
                               counts=ref["counts"], groups=ref["groups"])
    return SimpleNamespace(answer=ref,
                           counts={"filter.lineitem": ref["filter.lineitem"]},
                           groups=None)


def control(cell: dict, seed: int, device, dtype=torch.float32) -> dict:
    config, mix = cell["config"], cell["mix"]
    rmod = spec.reference(mix["query"])
    sf, chunks = config["scale_factor"], config["chunks"]
    stream = mixes.stream(mix, seed)
    for _ in range(mix["warmup_queries"]):
        next(stream)
    params = [next(stream) for _ in range(mix["check_queries"])]
    every = None
    if chunks > 1:
        every = {k: torch.cat([tpch.customer(sf, seed, c, chunks, device)[k]
                               for c in range(chunks)])
                 for k in ("c_custkey", "c_mktsegment")}
    want = {i: [] for i in range(len(params))}
    low = {i: [] for i in range(len(params))}
    for c in range(chunks):
        db = tpch.generate(sf, seed, c, chunks, device)
        for i, p in enumerate(params):
            kw = {} if every is None else {"customers": every}
            want[i].append(rmod.reference(db, p, **kw))
            low[i].append(rmod.reference(db, p, dtype, **kw))
        del db
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    readings = [rmod.readings(as_result(rmod.combine(low[i])),
                              rmod.combine(want[i]))
                for i in range(len(params))]
    checked = checks(readings, rmod.LIMITS)
    return {"seed": seed, "workload": cell["name"], "dtype": str(dtype),
            "correct": verdict(checked), "checks": checked}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    cell = spec.cell(spec.load_benchmark(), args.workload)
    for s in args.seeds.split(","):
        print(json.dumps(control(cell, int(s), torch.device(args.device))),
              flush=True)
    sys.stdout.flush()


if __name__ == "__main__":
    main()
