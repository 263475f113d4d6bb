"""A traced run of a one-chip cell, split by libgdf_tpu_torch's own spans.

    python3 -m gdfbench.program_split --workload <cell> --seed <n> \
        --seconds <s> [--program-spans 0|1]

From the root of a checkout, on a card; not part of a benchmark run. The
run is the benchmark's traced run (harness.run_single), whose trace is
kept and read again (metrics/_program.py): the device's idle time split
into host waits by sync site, enqueue by operator and the rest; the
device ms a query inside each `libgdf.op.*` span and `libgdf.sort`,
beside the benchmark's own `gdfbench.*` spans; and the program's
`host_sync` counter over the window beside the window's `libgdf.sync.*`
spans. `--program-spans 0` turns the program's spans off for the run (its
counter still counts), so that two runs price them by the window's
queries. Prints one JSON line, with the cost of a span on this host.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import timeit  # noqa: E402
from unittest import mock  # noqa: E402

from gdfbench import harness, spec  # noqa: E402
from gdfbench.metrics import _program  # noqa: E402


def span_cost_us(n: int = 20000) -> dict:
    """Microseconds of one enter and exit of a program span, off and under
    a CPU profiler."""
    from torch.profiler import ProfilerActivity, profile

    from libgdf_tpu_torch.utils import tracing

    def one():
        with tracing.span("libgdf.op.cost"):
            pass

    out = {"off": timeit.timeit(one, number=n) / n * 1e6}
    with profile(activities=[ProfilerActivity.CPU]):
        out["on"] = timeit.timeit(one, number=n) / n * 1e6
    return out


def report(trace, queries: int, counts: dict) -> dict:
    """The split of one traced window, a query where it says so."""
    split = _program.idle_split(trace)
    ms = {}
    for e in _program.spans(trace):
        name = e["name"]
        if name.startswith(_program.OP) or name == _program.SORT:
            ms.setdefault(name, None)
    for name in ms:
        ms[name] = _program.device_s_inside(trace, name) * 1e3 / queries
    for layer in ("filter", "project", "join", "groupby", "orderby",
                  "fetch"):
        ms[f"gdfbench.{layer}"] = \
            trace.span_device_s(f"gdfbench.{layer}") * 1e3 / queries
    busy = trace.busy_s()
    return {
        "queries": queries, "window_s": trace.window_s, "busy_s": busy,
        "idle_s": trace.window_s - busy, "sync_idle_s": split["sync"],
        "enqueue_idle_s": split["enqueue"],
        "rest_idle_s": trace.window_s - busy - split["sync"]
        - split["enqueue"],
        "sync_sites_s": dict(sorted(split["sync_sites"].items(),
                                    key=lambda kv: -kv[1])),
        "enqueue_ops_s": dict(sorted(split["enqueue_ops"].items(),
                                     key=lambda kv: -kv[1])),
        "sync_spans": len(_program.spans(trace, _program.SYNC)),
        "host_sync": counts,
        "device_ms_per_query": ms,
        "device_event_ms_per_query": sum(
            float(e.get("dur", 0.0)) for e in trace.device) / 1e3 / queries,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--program-spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("gdfbench.program_split: needs a CUDA device")
    from libgdf_tpu_torch.utils import tracing
    cell = spec.cell(spec.load_benchmark(), args.workload)
    if cell["workload"]["chips"] != 1:
        sys.exit("gdfbench.program_split: one-chip cells only")

    kept, counts = [], {}
    real_profiler, real_trace = harness.profiler, harness.Trace

    @contextlib.contextmanager
    def counted(on, devices):
        with real_profiler(on, devices) as prof:
            tracing.reset_counters()
            yield prof
            counts.update(tracing.counters())

    def keep(data):
        kept.append(real_trace(data))
        return kept[-1]

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(harness, "profiler", counted))
        stack.enter_context(mock.patch.object(harness, "Trace", keep))
        if not args.program_spans:
            stack.enter_context(mock.patch.object(tracing, "_profiling",
                                                  lambda: False))
        out = harness.run_single(cell, args.seed, args.seconds, True,
                                 "cuda:0", T0)
    line = {"workload": args.workload, "seed": args.seed,
            "program_spans": bool(args.program_spans),
            "card": torch.cuda.get_device_name(0),
            "correct": out["correct"], "per_layer": out["metrics"],
            **report(kept[0], out["attempted"], counts),
            "span_cost_us": span_cost_us()}
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
