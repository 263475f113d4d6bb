"""The run of one cell: tables from the seed, warm-up, the closed loop of
one client over the window, the check of the window's answers, and the
numbers the result line carries.

`run_single` runs a one-chip cell in this process. `run_mesh` runs a cell
over a mesh: one process of a group of W (`Group`, the worker of
gdfbench/worker.py) or, for the tests, every shard in this process
(`Group()`, a threads mesh). The harness measures; the program under test
is the plan in queries/<query>.py over libgdf_tpu_torch.
"""
from __future__ import annotations

import contextlib
import random
import statistics
import time

import torch

from . import mix as mixes, spec
from .data import tpch
from .imports import forbidden_modules
from .queries import QueryResult
from .trace import Trace, export

GIB = 2 ** 30


def span_factory(on: bool):
    """span(name): a profiler range `gdfbench.<name>` when tracing, else
    nothing."""
    if not on:
        return lambda name: contextlib.nullcontext()
    return lambda name: torch.profiler.record_function(f"gdfbench.{name}")


@contextlib.contextmanager
def profiler(on: bool, devices):
    """torch.profiler over the block (CPU and, on a card, CUDA activity)."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in devices):
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def sync(devices) -> None:
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class Reservoir:
    """A uniform sample of at most k of the window's queries, drawn from
    the seed: the same seed and query count keep the same ones."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(f"check:{seed}")
        self.seen = 0

    def offer(self) -> int | None:
        """The slot of the query just finished, or None to drop it."""
        i, self.seen = self.seen, self.seen + 1
        if i < self.k:
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.k else None


def host_result(res: QueryResult) -> QueryResult:
    """A result with its group-by output on the host (kept for the check)."""
    groups = None if res.groups is None else \
        {k: v.cpu() for k, v in res.groups.items()}
    return QueryResult(answer=res.answer, counts=res.counts, groups=groups,
                       filter_bytes=res.filter_bytes)


def p90(values) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def worst(readings: list) -> dict:
    """Each number's worst (largest) reading over the checked queries."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def checks(readings: list, limits: dict) -> dict:
    w = worst(readings)
    return {k: {"value": w[k], "limit": limits[k]} for k in limits
            if k in w}


def verdict(checked: dict) -> bool:
    return bool(checked) and all(c["value"] <= c["limit"]
                                 for c in checked.values())


def card_name(device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def per_layer(cell: dict, ctx: dict) -> dict:
    out = {}
    for m in cell["per_layer"]:
        v = spec.reader(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def end_to_end(cell: dict, values: dict) -> dict:
    return {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
            for m in cell["end_to_end"] if m["name"] in values}


def _peak(devices) -> int:
    return max((torch.cuda.max_memory_allocated(d) for d in devices
                if d.type == "cuda"), default=0)


def _reset_peak(devices) -> None:
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)


def run_single(cell: dict, seed: int, seconds: float, trace: bool,
               device, t0: float) -> dict:
    """One run of a one-chip cell on `device`; `t0` is the process's start
    on the perf_counter clock. Returns the result line's fields."""
    config, mix = cell["config"], cell["mix"]
    qmod, rmod = spec.query(mix["query"]), spec.reference(mix["query"])
    dev = torch.device(device)
    db = tpch.generate(config["scale_factor"], seed, 0, 1, dev)
    scanned = next(iter(db[qmod.SCANS].values())).shape[0]
    state = qmod.prepare(db, config)
    params = mixes.stream(mix, seed)
    quiet = span_factory(False)
    for _ in range(mix["warmup_queries"]):
        qmod.run(state, next(params), quiet)
    sync([dev])
    setup_peak = _peak([dev])
    _reset_peak([dev])

    span = span_factory(trace)
    keep = Reservoir(mix["check_queries"], seed)
    kept, lat, fbytes = {}, [], 0
    setup_s = time.perf_counter() - t0
    with profiler(trace, [dev]) as prof:
        with span("window"):
            start = time.perf_counter()
            while True:
                p = next(params)
                q0 = time.perf_counter()
                res = qmod.run(state, p, span)
                sync([dev])
                q1 = time.perf_counter()
                lat.append(q1 - q0)
                fbytes += sum(res.filter_bytes)
                slot = keep.offer()
                if slot is not None:
                    kept[slot] = (p, host_result(res))
                if q1 - start >= seconds:
                    break
            window_s = q1 - start
    del res
    peak = _peak([dev])
    tr = Trace(export(prof)) if trace else None
    del state

    readings = [rmod.readings(r, rmod.combine([rmod.reference(db, p)]))
                for p, r in kept.values()]
    checked = checks(readings, rmod.LIMITS)
    ctx = {"trace": tr, "queries": len(lat), "filter_bytes": fbytes,
           "window_s": window_s, "exchange_s": None, "local_shards": 1}
    return finish(cell, trace, dev, 1, lat, scanned * len(lat), window_s,
                  setup_s, peak, max(peak, setup_peak), ctx, checked)


def finish(cell, trace, dev, count, lat, rows, window_s, setup_s, peak,
           peak_all, ctx, checked, busy=None) -> dict:
    """The result line's fields from a run's readings."""
    tr = ctx.get("trace")
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": card_name(dev), "count": count,
              "memory_peak_bytes": int(peak_all)}
    out = {"correct": verdict(checked), "attempted": len(lat), "failed": 0}
    if trace:
        out["metrics"] = per_layer(cell, ctx)
        device["busy_s"] = tr.busy_s() if busy is None else busy
        device["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    else:
        out["metrics"] = end_to_end(cell, {
            "rows_per_s": rows / window_s,
            "query_p90_ms": p90(lat) * 1e3,
            "peak_mem_gib": peak / GIB,
            "setup_s": setup_s})
    out["device"] = device
    out["checks"] = checked
    return out


class Group:
    """The processes of a run over a mesh. The default, one process that
    holds every shard, needs no communication; `ProcessGroup` (worker.py)
    is one of W processes."""

    rank, size = 0, 1

    def gather(self, obj) -> list:
        return [obj]

    def go(self, flag: bool) -> bool:
        return flag

    def barrier(self) -> None:
        pass


def _mesh_tables(config, seed, chunks_here, devices, group):
    """This process's chunks, padded to one capacity a table, and every
    shard's live rows in global shard order."""
    sf, chunks = config["scale_factor"], config["chunks"]
    dbs = [tpch.generate(sf, seed, c, chunks, d)
           for c, d in zip(chunks_here, devices)]
    mine = {t: [next(iter(db[t].values())).shape[0] for db in dbs]
            for t in tpch.TABLES}
    every = group.gather(mine)
    counts = {t: [n for m in every for n in m[t]] for t in tpch.TABLES}
    locals_ = {t: [tpch.pad_rows(db[t], max(counts[t])) for db in dbs]
               for t in tpch.TABLES}
    return dbs, locals_, counts


def run_mesh(cell: dict, seed: int, seconds: float, trace: bool, mesh,
             group: Group, t0: float) -> dict | None:
    """One run of a cell over `mesh`, this process's part. Returns the
    result line's fields in the group's rank 0, its readings elsewhere."""
    config, mix = cell["config"], cell["mix"]
    qmod, rmod = spec.query(mix["query"]), spec.reference(mix["query"])
    devices = list(mesh.devices)
    chunks_here = list(mesh.local_ranks)
    dbs, locals_, counts = _mesh_tables(config, seed, chunks_here, devices,
                                        group)
    scanned = sum(counts[qmod.SCANS])
    state = qmod.prepare_dist(mesh, locals_, counts, config)
    params = mixes.stream(mix, seed)
    quiet = span_factory(False)
    for _ in range(mix["warmup_queries"]):
        group.barrier()
        qmod.run_dist(state, next(params), quiet)
        sync(devices)
    group.barrier()
    setup_peak = _peak(devices)
    _reset_peak(devices)
    mesh.exchange.reset()

    span = span_factory(trace)
    keep = Reservoir(mix["check_queries"], seed)
    kept, lat, fbytes = {}, [], 0
    setup_s = time.perf_counter() - t0
    window_epoch = time.time()
    done = False
    with profiler(trace, devices) as prof:
        with span("window"):
            start = time.perf_counter()
            while group.go(not done):
                p = next(params)
                q0 = time.perf_counter()
                res = qmod.run_dist(state, p, span)
                sync(devices)
                group.barrier()
                q1 = time.perf_counter()
                lat.append(q1 - q0)
                fbytes += sum(res.filter_bytes)
                slot = keep.offer()
                if slot is not None:
                    kept[slot] = (p, host_result(res))
                done = q1 - start >= seconds
            window_s = q1 - start
    del res
    exchange_s = mesh.exchange.seconds
    peak = _peak(devices)
    tr = Trace(export(prof)) if trace else None
    del state, locals_

    # the reference: each process its chunks' orders and line items, whose
    # customers may lie in any chunk
    sf, chunks = config["scale_factor"], config["chunks"]
    every = {k: torch.cat([tpch.customer(sf, seed, c, chunks, devices[0])[k]
                           for c in range(chunks)])
             for k in ("c_custkey", "c_mktsegment")}
    parts = {slot: [rmod.reference(db, p, customers=every) for db in dbs]
             for slot, (p, _) in kept.items()}
    del every
    ctx = {"trace": tr, "queries": len(lat), "filter_bytes": fbytes,
           "window_s": window_s, "exchange_s": exchange_s,
           "local_shards": len(chunks_here)}
    mine = {"parts": parts,
            "groups": {s: r.groups for s, (_, r) in kept.items()},
            "metrics": per_layer(cell, ctx) if trace else {},
            "busy_s": tr.busy_s() if trace else None,
            "peak": peak, "peak_all": max(peak, setup_peak),
            "forbidden": forbidden_modules()}
    every = group.gather(mine)
    if group.rank != 0:
        return None

    readings = []
    for slot, (p, res) in kept.items():
        want = rmod.combine([part for m in every for part in m["parts"][slot]])
        got = QueryResult(answer=res.answer, counts=res.counts, groups={
            k: torch.cat([m["groups"][slot][k] for m in every])
            for k in res.groups})
        readings.append(rmod.readings(got, want))
    checked = checks(readings, rmod.LIMITS)
    out = finish(cell, trace, devices[0], config["chips"], lat,
                 scanned * len(lat), window_s, setup_s,
                 max(m["peak"] for m in every),
                 max(m["peak_all"] for m in every), ctx, checked,
                 busy=statistics.mean(m["busy_s"] for m in every)
                 if trace else None)
    if trace:
        out["metrics"] = {
            name: {"value": statistics.mean(m["metrics"][name]["value"]
                                            for m in every),
                   "unit": v["unit"]}
            for name, v in every[0]["metrics"].items()
            if all(name in m["metrics"] for m in every)}
    return {"window_epoch": window_epoch,
            "forbidden": sorted({f for m in every for f in m["forbidden"]}),
            **out}
