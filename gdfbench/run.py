"""Run one cell of the benchmark and print its result line.

    python3 -m gdfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. `--trace 0` prints the cell's end-to-end
metrics, `--trace 1` its per-layer metrics and a breakdown from
torch.profiler over the window. The last lines on standard error are each
number compared beside its limit; the last line on standard output is one
JSON object. A cell on one chip runs in this process; a cell on several
starts one worker process a card (gdfbench/worker.py, through
libgdf_tpu_torch.parallel.procs) and prints the line of their rank 0.

Exits non-zero, printing no result, without CUDA or with fewer cards than
the cell asks for, without libgdf_tpu_torch, or when jax, jaxlib, flax or
libgdf_tpu is loaded.
"""
import time

T0 = time.perf_counter()
T0_EPOCH = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from gdfbench import spec  # noqa: E402
from gdfbench.imports import forbidden_modules  # noqa: E402
from gdfbench.roofline import PEAK_SOURCE  # noqa: E402

WORKER_TAG = "GDFBENCH_WORKER "
RUN_LIMIT_S = 340            # a worker group's share of a run's 360 s


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def refuse(msg: str, code: int = 2):
    print(f"gdfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def check_imports(where: str):
    bad = forbidden_modules()
    if bad:
        refuse(f"{where}: forbidden modules loaded: {bad}", 3)


def card_lines() -> list:
    """Each card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi unavailable: {e}"]


def print_result(out: dict) -> None:
    """The compared numbers as the last lines on stderr, then the line."""
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)


def run_workers(cell, args) -> dict:
    """Start the cell's worker processes, one a card, and return rank 0's
    result fields; raises if a worker failed."""
    from libgdf_tpu_torch.parallel import procs
    procs_n = cell["config"]["processes"]

    def command(coord, rank):
        return [sys.executable, "-m", "gdfbench.worker",
                "--workload", args.workload, "--seed", str(args.seed),
                "--seconds", str(args.seconds), "--trace", str(args.trace),
                "--coordinator", coord, "--rank", str(rank),
                "--procs", str(procs_n)]

    left = RUN_LIMIT_S - (time.perf_counter() - T0)
    outs = procs.start(command, procs_n, left)
    for text in outs[1:]:
        sys.stderr.write(text[-2000:])
    sys.stderr.write(outs[0][-6000:])
    lines = [ln for ln in outs[0].splitlines() if ln.startswith(WORKER_TAG)]
    if not lines:
        raise RuntimeError("rank 0 printed no result")
    out = json.loads(lines[-1][len(WORKER_TAG):])
    if out.pop("forbidden"):
        refuse("a worker loaded a forbidden module", 3)
    epoch = out.pop("window_epoch")
    if args.trace == 0:
        out["metrics"]["setup_s"]["value"] = epoch - T0_EPOCH
    return out


def main(argv=None):
    args = parse(argv)
    check_imports("at start")
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    chips = cell["workload"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        refuse(f"{args.workload} needs {chips} CUDA device(s); this machine "
               f"has {torch.cuda.device_count()}")
    try:
        import libgdf_tpu_torch  # noqa: F401
    except ImportError as e:
        refuse(f"the program under test does not import: {e}")
    for line in card_lines():
        print(f"card: {line}; peak: {PEAK_SOURCE}", file=sys.stderr,
              flush=True)
    if chips == 1:
        from gdfbench.harness import run_single
        out = run_single(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda:0", T0)
    else:
        out = run_workers(cell, args)
    check_imports("after the window")
    out["checks"] = out.pop("checks")
    print_result(out)


if __name__ == "__main__":
    main()
