"""TPC-H's database (``perfbench/tpch.py``) against the specification's
rules at small scale factors; the port's HYBRID and ONDEMAND tables over
a tiny TPC-H database against the plain reference and the program's
brute-force oracle; and whole runs of the two cells that came with it,
on the CPU at a small scale."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness, tpch
from perfbench import reference as R
from perfbench.generator import axis_of, build_db, rels_of

CONFIGS = Path(__file__).resolve().parent / "configs"
CFG = json.loads((CONFIGS / "tpch_sf1.json").read_text())
SF = 0.01


@pytest.fixture(scope="module")
def base():
    """The database the configuration's ``data_seed`` draws at SF 0.01,
    with the specification's keys (entity ``i`` has key ``i + 1``)."""
    return tpch.draw(CFG, int(CFG["data_seed"]), SF)


def test_sizes_by_scale_factor(base):
    assert base["sizes"] == {"nation": 25, "customer": 1_500,
                             "orders": 15_000, "part": 2_000,
                             "supplier": 100}
    assert tpch.sizes(1.0) == {e["name"]: e["size"]
                               for e in CFG["entities"]}
    assert tpch.sizes(0.001)["nation"] == 25
    for et, cols in base["entities"].items():
        want = {a for a, _ in next(e for e in CFG["entities"]
                                   if e["name"] == et)["attrs"]}
        assert set(cols) == want
        for col in cols.values():
            assert col.shape == (base["sizes"][et],) and col.dtype == np.int32
    np.testing.assert_array_equal(base["entities"]["nation"]["n_regionkey"],
                                  tpch.REGION_OF_NATION)


def test_functional_relationships(base):
    """Each customer and each supplier has one nation; each order has one
    customer, never one whose key is divisible by 3."""
    n = base["sizes"]
    for rel, et in (("cust_nation", "customer"), ("supp_nation", "supplier")):
        src, dst, _ = base["relations"][rel]
        np.testing.assert_array_equal(np.sort(src), np.arange(n[et]))
        assert dst.min() >= 0 and dst.max() < 25
    cust, orders, _ = base["relations"]["placed"]
    np.testing.assert_array_equal(np.sort(orders), np.arange(n["orders"]))
    assert not np.any((cust.astype(np.int64) + 1) % 3 == 0)
    assert np.unique(cust).size > n["customer"] // 2


def test_four_suppliers_a_part_by_the_formula(base):
    n_part, n_supp = base["sizes"]["part"], base["sizes"]["supplier"]
    part, supp, cols = base["relations"]["partsupp"]
    assert cols == {} and part.size == 4 * n_part
    got = {}
    for p, s in zip(part.tolist(), supp.tolist()):
        got.setdefault(p, set()).add(s)
    for p in range(n_part):
        key = p + 1
        want = {(key + i * (n_supp // 4 + (key - 1) // n_supp)) % n_supp
                for i in range(4)}
        assert got[p] == want and len(want) == 4


def test_one_to_seven_lines_an_order(base):
    orders, parts, cols = base["relations"]["lineitem"]
    per = np.bincount(orders, minlength=base["sizes"]["orders"])
    assert per.min() >= 1 and per.max() <= 7
    assert set(np.unique(per).tolist()) == set(range(1, 8))
    pairs = orders.astype(np.int64) * base["sizes"]["part"] + parts
    assert np.unique(pairs).size == pairs.size     # a repeated part kept once
    assert abs(per.mean() - 4.0) < 0.1
    assert set(cols) == {"l_returnflag", "l_linestatus", "l_shipmode"}


def test_status_and_return_flag_follow_the_dates(base):
    """``l_returnflag`` is R or A only where ``l_linestatus`` is F;
    ``o_orderstatus`` is F (O) only where every line is F (O), and P
    wherever the order's lines are mixed."""
    orders, _, cols = base["relations"]["lineitem"]
    flag, status = cols["l_returnflag"], cols["l_linestatus"]
    assert np.all(status[flag != tpch.N] == tpch.F)
    assert np.any(flag == tpch.R) and np.any(flag == tpch.A)
    assert np.any((flag == tpch.N) & (status == tpch.F))
    n_orders = base["sizes"]["orders"]
    lines = np.bincount(orders, minlength=n_orders)
    f_lines = np.bincount(orders, weights=status == tpch.F,
                          minlength=n_orders)
    o_status = base["entities"]["orders"]["o_orderstatus"]
    assert np.all(f_lines[o_status == tpch.F] == lines[o_status == tpch.F])
    assert np.all(f_lines[o_status == tpch.O] == 0)
    mixed = (f_lines > 0) & (f_lines < lines)
    assert np.all(o_status[mixed] == tpch.P)
    shares = np.bincount(o_status, minlength=3) / n_orders
    assert 0.4 < shares[tpch.F] < 0.6 and 0.4 < shares[tpch.O] < 0.6
    assert 0 < shares[tpch.P] < 0.1


def _joint(arrays, rel, src_et, dst_et):
    """Each edge's endpoints' attribute codes and its own attributes,
    counted: what a renumbering leaves as it is."""
    src, dst, cols = arrays["relations"][rel]

    def code(et, idx):
        out = np.zeros(idx.size, np.int64)
        for col in arrays["entities"][et].values():
            out = out * 8 + col[idx]
        return out
    key = code(src_et, src) * 64 + code(dst_et, dst)
    for col in cols.values():
        key = key * 8 + col
    return np.unique(key, return_counts=True)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, -3])
def test_a_seed_renumbers_one_database(seed):
    a = tpch.generate(CFG, seed, 0.002)
    b = tpch.generate(CFG, seed, 0.002)
    other = tpch.generate(CFG, seed + 1, 0.002)
    moved = False
    for r in CFG["relationships"]:
        name = r["name"]
        for x, y in zip(a["relations"][name][:2], b["relations"][name][:2]):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(_joint(a, name, r["src"], r["dst"]),
                        _joint(other, name, r["src"], r["dst"])):
            np.testing.assert_array_equal(x, y)
        moved |= not np.array_equal(a["relations"][name][0],
                                    other["relations"][name][0])
    assert moved
    for et, cols in a["entities"].items():
        for name, col in cols.items():
            np.testing.assert_array_equal(
                np.bincount(col), np.bincount(other["entities"][et][name]))


# -- the port's tables over a tiny TPC-H database -----------------------------

def _points(db):
    from repro_torch.core import build_lattice
    return list(build_lattice(db.schema, 2))


@pytest.mark.parametrize("strategy", ["HYBRID", "ONDEMAND"])
def test_port_tables_equal_the_reference_and_the_oracle(strategy):
    """Every lattice point of chains of 2 (10 points) over a database at
    SF 0.0001 (customer 15, orders 150, part 20, supplier 1): the port's
    complete table, on the sparse executor, equals the reference's and
    the oracle's grounding by grounding count."""
    from repro_torch.core import make_strategy
    from repro_torch.core.oracle import oracle_ct
    arrays = tpch.generate(CFG, 17, 0.0001)
    assert arrays["sizes"]["orders"] == 150
    db = build_db(CFG, arrays)
    ref = R.Reference(CFG, arrays)
    points = _points(db)
    assert len(points) == 10
    strat = make_strategy(strategy, executor="sparse", device="cpu")
    strat.prepare(db, points)
    for point in points:
        keep = tuple(point.all_ct_vars(db.schema, include_rind=True))
        got = strat.family_ct(point, keep).counts.to(torch.float64).numpy()
        want = ref.family(rels_of(point), [axis_of(v) for v in keep])
        np.testing.assert_array_equal(got, want.numpy())
        np.testing.assert_array_equal(got, oracle_ct(db, point, keep))


# -- whole runs of the new cells ----------------------------------------------

TPCH = ("tpch_sf1.hybrid.discover", 0.002)
ONDEMAND = ("imdb_synth.ondemand.discover", 0.0005)


@pytest.mark.parametrize("cell", [TPCH, ONDEMAND], ids=lambda c: c[0])
def test_new_cells_run_correct(cell):
    name, scale = cell
    result, lines = harness.run(name, 2 ** 31 + 77, 0.3, False,
                                device="cpu", scale=scale)
    assert result["correct"], lines
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"discovery_s", "setup_s"}
    assert set(result["checks"]) == {"table_gap", "score_gap", "choice_gap"}


def _scaled(fn, factor):
    def wrong(*args, **kwargs):
        return fn(*args, **kwargs) * factor
    return wrong


@pytest.mark.parametrize("target,number", [
    ("segsum_ones", "table_gap"),       # K1: leaf hops' positive counts
    ("mobius", "table_gap"),            # K3: negative groundings
    ("bdeu", "score_gap"),              # K4: scores
])
@pytest.mark.parametrize("cell", [TPCH, ONDEMAND], ids=lambda c: c[0])
def test_new_cell_with_an_altered_kernel_is_not_correct(monkeypatch, cell,
                                                        target, number):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, target, _scaled(getattr(ops, target), 1.001))
    name, scale = cell
    result, lines = harness.run(name, 5, 0.2, False, device="cpu",
                                scale=scale)
    assert not result["correct"], lines
    check = result["checks"][number]
    assert check["value"] > check["limit"]
