"""The traffic generator: a mix's parameter rules -> the stream of queries.

A mix (traffic/<mix>.json) names its query and the domain of each
substitution parameter: `int_range` (low..high, both included) or `choice`
(a list of values). The stream visits every combination of the domains
once a pass, each pass in a permutation drawn from the seed, so that every
seed runs the same set of parameters, in another order.
"""
from __future__ import annotations

import itertools
import random


def domain(rule: dict) -> list:
    if rule["kind"] == "int_range":
        return list(range(int(rule["low"]), int(rule["high"]) + 1))
    if rule["kind"] == "choice":
        return list(rule["values"])
    raise ValueError(f"unknown parameter kind {rule['kind']!r}")


def combinations(mix: dict) -> list:
    """Every combination of the parameters, as dicts, in a fixed order."""
    names = sorted(mix["parameters"])
    doms = [domain(mix["parameters"][n]) for n in names]
    return [dict(zip(names, vals)) for vals in itertools.product(*doms)]


def stream(mix: dict, seed: int):
    """The endless stream of one client's parameters."""
    combos = combinations(mix)
    rng = random.Random(f"traffic:{seed}")
    while True:
        order = list(range(len(combos)))
        rng.shuffle(order)
        for i in order:
            yield dict(combos[i])
