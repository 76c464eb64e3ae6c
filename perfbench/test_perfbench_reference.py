"""The plain reference against a brute-force count over every grounding,
on tiny databases of both configurations; and the frozen generator."""

import itertools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import reference as R
from perfbench import synth

CONFIGS = Path(__file__).resolve().parent / "configs"


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def points(cfg, max_length):
    """The lattice: every connected, tree-shaped set of at most
    ``max_length`` relationships, as sorted tuples of names."""
    rels = {r["name"]: r for r in cfg["relationships"]}
    out = []
    for length in range(1, max_length + 1):
        for combo in itertools.combinations(sorted(rels), length):
            parent = {}

            def find(v):
                while parent.setdefault(v, v) != v:
                    v = parent[v]
                return v

            tree = True
            for name in combo:
                r = rels[name]
                a = find((r["src"], 0))
                b = find((r["dst"], 1 if r["src"] == r["dst"] else 0))
                tree &= a != b
                parent[a] = b
            if tree and len({find(v) for v in list(parent)}) == 1:
                out.append(tuple(combo))
    return out


def brute_force(ref, arrays, rels):
    """The complete table of a point by visiting every grounding (one
    entity per variable), vectorised over the groundings."""
    atoms = ref.atoms(rels)
    vars_ = sorted({v for a in atoms for v in a[1:]})
    axes = ref.point_axes(rels)
    grids = np.meshgrid(*[np.arange(arrays["sizes"][v[0]]) for v in vars_],
                        indexing="ij")
    x = {v: g.ravel().astype(np.int64) for v, g in zip(vars_, grids)}
    hit, where = {}, {}
    for rel, s, d in atoms:
        src, dst, _ = arrays["relations"][rel]
        n_dst = arrays["sizes"][d[0]]
        codes = src.astype(np.int64) * n_dst + dst
        order = np.argsort(codes)
        want = x[s] * n_dst + x[d]
        pos = np.clip(np.searchsorted(codes[order], want), 0, len(codes) - 1)
        hit[rel] = codes[order][pos] == want
        where[rel] = order[pos]
    index = []
    for ax in axes:
        if ax.kind == "attr":
            et, copy, name = ax.owner
            index.append(arrays["entities"][et][name][x[(et, copy)]])
        elif ax.kind == "edge":
            rel, name = ax.owner
            col = arrays["relations"][rel][2][name][where[rel]]
            index.append(np.where(hit[rel], col, ax.card - 1))
        else:
            index.append(hit[ax.owner[0]].astype(np.int64))
    shape = [ax.card for ax in axes]
    flat = np.ravel_multi_index(index, shape)
    return np.bincount(flat, minlength=int(np.prod(shape))).reshape(shape)


@pytest.mark.parametrize("name,scale,length", [
    ("imdb_synth", 0.001, 2), ("vg_synth", 0.00005, 3)])
def test_reference_equals_every_grounding(name, scale, length):
    cfg = config(name)
    arrays = synth.generate(cfg, 20240611, scale)
    ref = R.Reference(cfg, arrays)
    points_ = points(cfg, length)
    assert points_
    for rels in points_:
        axes, table = ref.complete(rels)
        assert axes == ref.point_axes(rels)
        want = brute_force(ref, arrays, rels)
        np.testing.assert_array_equal(table.numpy(), want)


def test_lattice_sizes():
    """IMDb's chains of 2 make 6 points; VisualGenome's chains of 3, 56."""
    assert len(points(config("imdb_synth"), 2)) == 6
    assert len(points(config("vg_synth"), 3)) == 56


def test_family_is_a_projection_in_the_order_asked():
    cfg = config("imdb_synth")
    arrays = synth.generate(cfg, 3, 0.0002)
    ref = R.Reference(cfg, arrays)
    rels = ("imdb_R0", "imdb_R1")
    axes, full = ref.complete(rels)
    pick = [axes[-1], axes[2], axes[9]]
    fam = ref.family(rels, pick)
    want = full.sum(dim=[i for i in range(len(axes))
                         if i not in (2, 9, len(axes) - 1)])
    torch.testing.assert_close(fam, want.permute(2, 0, 1), rtol=0, atol=0)


def test_bdeu_matches_its_formula():
    """Eq. 1 on a small table, written out term by term."""
    from math import lgamma
    t = torch.tensor([[3.0, 1.0, 0.0], [2.0, 2.0, 5.0]], dtype=torch.float64)
    q, r, ess = 2, 3, 1.0
    want = 0.0
    for j in range(q):
        nj = float(t[j].sum())
        want += lgamma(ess / q) - lgamma(nj + ess / q)
        for k in range(r):
            want += lgamma(float(t[j, k]) + ess / (q * r)) - lgamma(
                ess / (q * r))
    score, scale = R.bdeu(t, ess)
    assert score == pytest.approx(want, rel=1e-12)
    assert scale >= abs(score)


def _joint(arrays, rel, src_et, dst_et):
    """Each edge's (src's first attribute, dst's first, edge attribute),
    counted: what a renumbering leaves as it is."""
    src, dst, cols = arrays["relations"][rel]
    a = next(iter(arrays["entities"][src_et].values()))[src]
    b = next(iter(arrays["entities"][dst_et].values()))[dst]
    c = next(iter(cols.values()))
    return np.bincount((a * 3 + b) * 3 + c, minlength=27)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, -3])
def test_generator_renumbers_one_database(seed):
    """The same seed gives the same arrays; another seed gives the same
    database with its entities renumbered and its edges reordered."""
    cfg = config("vg_synth")
    a = synth.generate(cfg, seed, 0.0001)
    b = synth.generate(cfg, seed, 0.0001)
    other = synth.generate(cfg, seed + 1, 0.0001)
    moved = False
    for r in cfg["relationships"]:
        name = r["name"]
        for x, y in zip(a["relations"][name][:2], b["relations"][name][:2]):
            np.testing.assert_array_equal(x, y)
        src, dst, _ = a["relations"][name]
        pairs = src.astype(np.int64) * 10 ** 6 + dst
        assert np.unique(pairs).size == pairs.size      # keyed by the pair
        np.testing.assert_array_equal(
            _joint(a, name, r["src"], r["dst"]),
            _joint(other, name, r["src"], r["dst"]))
        moved |= not np.array_equal(src, other["relations"][name][0])
    assert moved


def test_full_scale_sizes_match_the_paper():
    """The stand-ins' row counts at scale 1.0, from the configurations
    alone (nothing generated): IMDb 1,063,000 and VisualGenome 16M."""
    for name, rows in (("imdb_synth", 1_063_000), ("vg_synth", 16_000_000)):
        cfg = config(name)
        total = sum(e["size"] for e in cfg["entities"]) + sum(
            r["edges"] for r in cfg["relationships"])
        assert total == rows
