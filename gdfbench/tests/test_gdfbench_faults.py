"""Each fault that a cell can have, planted under the timed path of a run
on the CPU, makes `correct` come out false; the control (the reference in
float32 in the program's place) fails too, and the float64 reference in
the program's place passes."""
import pytest
import torch

from libgdf_tpu_torch import ops, parallel
from libgdf_tpu_torch.parallel import distributed

from gdfbench import control

from ._cells import SEED, run_cpu, small_cell


def stale_filter(monkeypatch):
    """A step that returns its state unchanged: the filter keeps the first
    query's stencil for every later query."""
    real = ops.compare_scalar
    first = {}

    def fake(col, value, op):
        key = (col.name, op, col.size)
        if key not in first:
            first[key] = real(col, value, op)
        return first[key]
    monkeypatch.setattr(ops, "compare_scalar", fake)


def half_rows(monkeypatch):
    """Half of the rows left out: the filter drops the second half."""
    real = ops.filter_table

    def fake(table, stencil):
        n = stencil.size
        half = torch.arange(n, device=stencil.data.device) < n // 2
        cut = stencil.with_data((stencil.data != 0) & half)
        return real(table, cut.with_data(cut.data.to(torch.int8)))
    monkeypatch.setattr(ops, "filter_table", fake)


def altered_answer(monkeypatch):
    """An answer altered where it is produced: every float aggregate of the
    group-by one part in a million high."""
    real = ops.groupby

    def fake(table, keys, aggs, dropna=True):
        out = real(table, keys, aggs, dropna)
        cols = [c.with_data(c.data * (1 + 1e-6)) if c.data.is_floating_point()
                else c for c in out.columns]
        return type(out).from_columns(cols, num_rows=out.num_rows)
    monkeypatch.setattr(ops, "groupby", fake)
    monkeypatch.setattr(distributed, "_local_groupby", fake)


def no_exchange(monkeypatch):
    """The exchange between chips left out: each shuffle keeps its shard's
    own rows, each all-gather gives its shard's own. (Q3's shuffle join
    alone would not show it: dbgen's chunks hold each order with its line
    items, so the join is right on unshuffled shards.)"""
    def shuffle(table, key_names, axis_name, slot_capacity, num_batches=1,
                return_overflow=False, salt=None):
        return (table, 0) if return_overflow else table

    def gather(table, axis_name):
        return table.with_num_rows(table.row_count())
    monkeypatch.setattr(distributed, "shuffle_shard", shuffle)
    monkeypatch.setattr(distributed, "all_gather_table", gather)
    monkeypatch.setattr(parallel, "all_gather_table", gather)


CASES = [("tpch_sf10.q1", 0.01, stale_filter),
         ("tpch_sf10.q1", 0.01, half_rows),
         ("tpch_sf10.q1", 0.01, altered_answer),
         ("tpch_sf10.q3", 0.01, stale_filter),
         ("tpch_sf10.q3", 0.01, half_rows),
         ("tpch_sf10.q3", 0.01, altered_answer),
         ("tpch_sf40_4card.q3", 0.04, stale_filter),
         ("tpch_sf40_4card.q3", 0.04, half_rows),
         ("tpch_sf40_4card.q3", 0.04, altered_answer),
         ("tpch_sf40_4card.q3", 0.04, no_exchange)]


@pytest.mark.parametrize("name,sf,fault", CASES,
                         ids=[f"{c[0]}-{c[2].__name__}" for c in CASES])
def test_fault_is_caught(monkeypatch, name, sf, fault):
    fault(monkeypatch)
    out = run_cpu(name, sf, seconds=1.0)
    assert out["attempted"] >= 2
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name,sf", [("tpch_sf10.q1", 0.02),
                                     ("tpch_sf10.q3", 0.02),
                                     ("tpch_sf40_4card.q3", 0.04)])
def test_control_fails_and_float64_passes(name, sf):
    cell = small_cell(name, sf)
    low = control.control(cell, SEED, torch.device("cpu"), torch.float32)
    assert not low["correct"], low
    same = control.control(cell, SEED, torch.device("cpu"), torch.float64)
    assert same["correct"], same
