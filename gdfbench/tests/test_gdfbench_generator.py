"""The TPC-H generator's distributions at SF 0.01 (clause 4.2.3)."""
import pytest
import torch

from gdfbench.data import tpch

SF = 0.01
SEED = 2 ** 31 + 17


@pytest.fixture(scope="module")
def db():
    return tpch.generate(SF, SEED)


def test_sizes_and_lines_a_order(db):
    o, li = db["orders"], db["lineitem"]
    assert o["o_orderkey"].shape[0] == 15_000
    assert db["customer"]["c_custkey"].shape[0] == 1_500
    keys, lines = torch.unique(li["l_orderkey"], return_counts=True)
    assert keys.shape[0] == 15_000
    assert int(lines.min()) == 1 and int(lines.max()) == 7
    assert 3.9 < float(lines.double().mean()) < 4.1


def test_sparse_order_keys_and_customers(db):
    ok = db["orders"]["o_orderkey"].long()
    assert bool((ok[1:] > ok[:-1]).all())
    assert bool(((ok - 1) % 32 < 8).all())
    assert ok[:9].tolist() == [1, 2, 3, 4, 5, 6, 7, 8, 33]
    ck = db["orders"]["o_custkey"].long()
    assert bool((ck % 3 != 0).all()) and int(ck.min()) >= 1
    assert int(ck.max()) <= 1_500
    assert tpch.customer_keys_not_div3(torch.arange(6)).tolist() == \
        [1, 2, 4, 5, 7, 8]


def test_price_formula(db):
    assert tpch.retail_cents(torch.tensor([1, 2, 10, 999, 1000])).tolist() \
        == [90100, 90200, 91001, 189999, 90100]
    li = db["lineitem"]
    cents = torch.round(li["l_extendedprice"] * 100).long()
    qty = li["l_quantity"].long()
    assert bool((cents % qty == 0).all())
    retail = cents // qty
    assert int(retail.min()) >= 90000
    assert int(retail.max()) <= 90000 + 20000 + 99900
    assert int(qty.min()) == 1 and int(qty.max()) == 50
    disc = torch.round(li["l_discount"] * 100).long()
    tax = torch.round(li["l_tax"] * 100).long()
    assert sorted(torch.unique(disc).tolist()) == list(range(11))
    assert sorted(torch.unique(tax).tolist()) == list(range(9))


def test_dates_and_flags(db):
    o, li = db["orders"], db["lineitem"]
    od = o["o_orderdate"].long()
    assert int(od.min()) >= tpch.START_DATE
    assert int(od.max()) <= tpch.ORDER_DATE_MAX
    pos = torch.searchsorted(o["o_orderkey"].long(), li["l_orderkey"].long())
    gap = li["l_shipdate"].long() - od[pos]
    assert int(gap.min()) == 1 and int(gap.max()) == 121
    ship = li["l_shipdate"].long()
    flag, status = li["l_returnflag"].long(), li["l_linestatus"].long()
    assert bool((status == (ship > tpch.CURRENT_DATE).long()).all())
    # receipt = ship + 1..30: after the current date -> N; 30 days before
    # it or more -> R or A, about half each
    assert bool((flag[ship >= tpch.CURRENT_DATE] == tpch.FLAG_N).all())
    early = flag[ship + 30 <= tpch.CURRENT_DATE]
    assert bool((early != tpch.FLAG_N).all())
    share_r = float((early == tpch.FLAG_R).double().mean())
    assert 0.45 < share_r < 0.55


def test_same_seed_same_tables_other_seed_other():
    a = tpch.generate(SF, SEED)
    b = tpch.generate(SF, SEED)
    c = tpch.generate(SF, SEED + 1)
    for t in tpch.TABLES:
        for k in a[t]:
            assert torch.equal(a[t][k], b[t][k])
    assert not torch.equal(a["lineitem"]["l_quantity"][:100],
                           c["lineitem"]["l_quantity"][:100])


def test_chunks_add_up_to_the_whole():
    whole = tpch.generate(0.04, SEED)
    parts = [tpch.generate(0.04, SEED, r, 4) for r in range(4)]
    for t, key in (("orders", "o_orderkey"), ("customer", "c_custkey")):
        cat = torch.cat([p[t][key] for p in parts])
        assert torch.equal(cat, whole[t][key])
    for p in parts:
        own = set(p["orders"]["o_orderkey"].tolist())
        assert set(p["lineitem"]["l_orderkey"].tolist()) == own
    n = sum(p["lineitem"]["l_orderkey"].shape[0] for p in parts)
    keys = torch.cat([p["lineitem"]["l_orderkey"] for p in parts])
    n_orders = whole["orders"]["o_orderkey"].shape[0]
    assert torch.unique(keys).shape[0] == n_orders
    assert 0.9 * 4 * 60_000 < n < 1.1 * 4 * 60_000


def test_pad_rows():
    t = {"a": torch.arange(3), "b": torch.ones(3, dtype=torch.int8)}
    p = tpch.pad_rows(t, 5)
    assert p["a"].tolist() == [0, 1, 2, 0, 0]
    assert p["b"].dtype == torch.int8 and p["b"].shape[0] == 5
