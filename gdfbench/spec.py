"""BENCHMARK.json and the files it names: a cell's configuration, traffic
mix, query, reference and metric readers, each found by its name."""
from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_benchmark(path: Path | None = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def module_name(metric: str) -> str:
    """A metric's reader module: its name with '.' and '-' as '_'."""
    return re.sub(r"[.\-]", "_", metric)


def reader(metric: str):
    return importlib.import_module(f"gdfbench.metrics.{module_name(metric)}")


def query(name: str):
    return importlib.import_module(f"gdfbench.queries.{name}")


def reference(name: str):
    return importlib.import_module(f"gdfbench.reference.{name}")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str) -> dict:
    """Everything one cell needs: its entry, configuration, traffic mix and
    metrics."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(ROOT / entry["file"]) as f:
        config = json.load(f)
    with open(PACKAGE / "traffic" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    return {"name": name, "workload": w, "config": config, "mix": mix,
            "end_to_end": [m for m in bench["end_to_end"]
                           if applies(m, name)],
            "per_layer": [m for m in bench["per_layer"]
                          if applies(m, name)]}
