"""The libgdf_tpu_torch plans of Q1 and Q3 against the plain reference at
SF 0.01 on the CPU, and Q3's plan over 4 in-process CPU shards."""
import pytest
import torch

from gdfbench import mix as mixes, spec
from gdfbench.data import tpch
from gdfbench.harness import span_factory

from ._cells import SEED, run_cpu, small_cell


@pytest.mark.parametrize("name", ["tpch_sf10.q1", "tpch_sf10.q3"])
def test_plan_equals_reference(name):
    cell = small_cell(name, 0.01)
    q = cell["mix"]["query"]
    qmod, rmod = spec.query(q), spec.reference(q)
    db = tpch.generate(0.01, SEED)
    state = qmod.prepare(db, cell["config"])
    stream = mixes.stream(cell["mix"], SEED)
    for _ in range(5):
        p = next(stream)
        got = qmod.run(state, p, span_factory(False))
        r = rmod.readings(got, rmod.combine([rmod.reference(db, p)]))
        for k, limit in rmod.LIMITS.items():
            assert r[k] <= limit, (k, r[k], p)


@pytest.mark.parametrize("name,sf", [("tpch_sf10.q1", 0.01),
                                     ("tpch_sf10.q3", 0.01),
                                     ("tpch_sf40_4card.q3", 0.04)])
def test_run_is_correct(name, sf):
    out = run_cpu(name, sf)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"rows_per_s", "query_p90_ms",
                                   "peak_mem_gib", "setup_s"}
    assert list(out)[-1] == "checks"


def test_four_shards_hold_every_group_once():
    """The sharded plan's groups, shard by shard, are the single-card
    plan's: each group on one shard."""
    cell = small_cell("tpch_sf40_4card.q3", 0.04)
    qmod = spec.query("q3")
    from libgdf_tpu_torch import parallel as par
    mesh = par.make_mesh(4, device="cpu")
    dbs = [tpch.generate(0.04, SEED, r, 4) for r in range(4)]
    counts = {t: [next(iter(d[t].values())).shape[0] for d in dbs]
              for t in tpch.TABLES}
    locals_ = {t: [tpch.pad_rows(d[t], max(counts[t])) for d in dbs]
               for t in tpch.TABLES}
    state = qmod.prepare_dist(mesh, locals_, counts, cell["config"])
    whole = {t: {k: torch.cat([d[t][k] for d in dbs]) for k in dbs[0][t]}
             for t in tpch.TABLES}
    one = qmod.prepare(whole, cell["config"])
    p = {"SEGMENT": 1, "DATE": 9200}
    got = qmod.run_dist(state, p, span_factory(False))
    want = qmod.run(one, p, span_factory(False))
    keys = got.groups["l_orderkey"]
    assert torch.unique(keys).shape[0] == keys.shape[0]
    assert sorted(keys.tolist()) == sorted(want.groups["l_orderkey"].tolist())
    assert list(got.answer["l_orderkey"]) == list(want.answer["l_orderkey"])
    for k, v in want.counts.items():
        assert sum(got.counts[k]) == v, k
