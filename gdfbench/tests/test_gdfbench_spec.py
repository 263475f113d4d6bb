"""BENCHMARK.json against the contract's shape: every cell, configuration,
traffic mix, query, reference and metric reader found by name, names and
units of the allowed characters."""
import json
import re

import pytest

from gdfbench import mix as mixes, spec

BENCH = spec.load_benchmark()
TEXT = re.compile(r"^[^\t\n]{1,200}$")
WIDTH_KEYS = re.compile(r"(_dim|_rank|hidden|intermediate|head|latent)")


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["paths"] == ["gdfbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(TEXT.match(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert spec.NAME.match(c["name"]) and TEXT.match(c["source"])
    assert TEXT.match(c["why"]) and c["file"].startswith("gdfbench/")
    assert len(c["reduced"]) <= 16
    assert all(spec.NAME.match(k) and not WIDTH_KEYS.search(k)
               for k in c["reduced"])
    body = json.loads((spec.ROOT / c["file"]).read_text())
    assert body["name"] == c["name"]
    assert body["reduced"] == c["reduced"]
    for key in c["reduced"]:
        assert key in body, key
    files = [x["file"] for x in BENCH["configs"]]
    assert files.count(c["file"]) == 1
    sources = [x["source"] for x in BENCH["configs"]]
    assert sources.count(c["source"]) == 1


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert spec.NAME.match(w["name"]) and spec.NAME.match(w["traffic"])
    assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
    cell = spec.cell(BENCH, w["name"])
    assert cell["config"]["chips"] == w["chips"]
    q = cell["mix"]["query"]
    assert hasattr(spec.query(q), "run")
    ref = spec.reference(q)
    assert set(ref.LIMITS) and hasattr(ref, "combine")
    if w["chips"] > 1:
        assert hasattr(spec.query(q), "run_dist")
    assert mixes.combinations(cell["mix"])
    names = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert cell["per_layer"]


def test_cells_and_pairs_unique_and_four_chip_share():
    names = [w["name"] for w in BENCH["workloads"]]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(names)) == len(names) and len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(names) // 4)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(m):
    allowed = {"name", "unit", "better", "source", "workloads"}
    if m in BENCH["end_to_end"]:
        allowed.add("bound")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert TEXT.match(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert hasattr(spec.reader(m["name"]), "read")
    assert set(m) <= allowed
    assert spec.NAME.match(m["name"]) and spec.UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"


def test_unique_metric_names():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)


def test_traffic_visits_every_combination_each_pass():
    mix = spec.cell(BENCH, "tpch_sf10.q3")["mix"]
    combos = mixes.combinations(mix)
    assert len(combos) == 5 * 31
    s = mixes.stream(mix, 2 ** 31 + 5)
    first = [tuple(sorted(next(s).items())) for _ in range(len(combos))]
    assert len(set(first)) == len(combos)
    again = mixes.stream(mix, 2 ** 31 + 5)
    assert [tuple(sorted(next(again).items())) for _ in range(10)] == \
        first[:10]
