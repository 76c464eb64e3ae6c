"""Parity of the PyTorch port's data model, planner and oracle with the JAX
package, its import boundary, and its device rule.

Also holds the helpers the other ``test_torch_*`` files use to hand a JAX
package database (and its lattice points / ct axes) to the port as plain
numpy arrays.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both frameworks in one process; JAX stays on CPU)
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro.core.oracle import oracle_ct as jax_oracle_ct
from repro_torch.core.oracle import oracle_ct as torch_oracle_ct
from repro_torch.kernels import ops
from repro_torch.kernels.segsum import IdPart
from tests.test_counting_core import tiny_db

CPU = "cpu"
SRC = Path(__file__).resolve().parents[1] / "src"


# ------------------------------------------------------------- helpers ----

def to_port(db):
    """A JAX package ``RelationalDB`` rebuilt in the port from its arrays."""
    spec = {
        "entities": [(et.name, et.size, [(a.name, a.card) for a in et.attrs])
                     for et in db.schema.entities],
        "relationships": [(rt.name, rt.src, rt.dst,
                           [(a.name, a.card) for a in rt.attrs])
                          for rt in db.schema.relationships],
    }
    ents = {n: dict(t.attrs) for n, t in db.entities.items()}
    rels = {n: (t.src, t.dst, dict(t.attrs)) for n, t in db.relations.items()}
    return tc.db_from_arrays(spec, ents, rels)


def var_to_port(v):
    return tc.Var(v.etype, v.copy)


def cv_to_port(cv):
    owner = ((var_to_port(cv.owner[0]), cv.owner[1]) if cv.kind == "attr"
             else tuple(cv.owner))
    return tc.CtVar(cv.kind, owner, cv.card)


def point_to_port(point):
    return tc.LatticePoint(tuple(
        tc.Atom(a.rel, var_to_port(a.src), var_to_port(a.dst))
        for a in point.atoms))


def keep_to_port(keep):
    return tuple(cv_to_port(cv) for cv in keep)


def edges_of(models):
    """``{point: sorted (parent, child) edges}`` with string names, so
    models of the two packages compare directly."""
    return {str(p): sorted((str(a), str(b)) for a, b in m.edges())
            for p, m in models.items()}


def signature_to_list(sig):
    return sig if not isinstance(sig, tuple) else [signature_to_list(s)
                                                   for s in sig]


# --------------------------------------------------------------- data ----

@pytest.mark.parametrize("name", jc.PAPER_DATASETS)
def test_paper_benchmark_db_byte_identical(name):
    assert tc.PAPER_DATASETS == jc.PAPER_DATASETS
    want = jc.paper_benchmark_db(name, seed=0, scale=0.01)
    got = tc.paper_benchmark_db(name, seed=0, scale=0.01)
    assert got.total_rows == want.total_rows
    assert str(got.schema) == str(want.schema).replace("repro.core",
                                                       "repro_torch.core")
    for en, et in want.entities.items():
        for an, col in et.attrs.items():
            g = got.entities[en].attrs[an]
            assert g.dtype == col.dtype and g.tobytes() == col.tobytes()
    for rn, rt in want.relations.items():
        gt = got.relations[rn]
        assert gt.src.tobytes() == rt.src.tobytes()
        assert gt.dst.tobytes() == rt.dst.tobytes()
        for an, col in rt.attrs.items():
            assert gt.attrs[an].tobytes() == col.tobytes()


@pytest.mark.parametrize("name", jc.PAPER_DATASETS)
def test_plans_match_over_lattice(name):
    jdb = jc.paper_benchmark_db(name, seed=0, scale=0.01)
    tdb = tc.paper_benchmark_db(name, seed=0, scale=0.01)
    jl, tl = jc.build_lattice(jdb.schema, 2), tc.build_lattice(tdb.schema, 2)
    assert [str(p) for p in jl] == [str(p) for p in tl]
    for jp, tp in zip(jl, tl):
        assert point_to_port(jp) == tp
        jplan = jc.compile_plan(jdb.schema, jp)
        tplan = tc.compile_plan(tdb.schema, tp)
        assert signature_to_list(tplan.tree_signature()) == \
            signature_to_list(jplan.tree_signature())
        assert tplan.keep == keep_to_port(jplan.keep)
        assert tplan.out_vars == keep_to_port(jplan.out_vars)


def test_db_from_arrays_round_trip():
    jdb = tiny_db(0)
    tdb = to_port(jdb)
    tdb.validate()
    assert tdb.total_rows == jdb.total_rows
    assert [e.name for e in tdb.schema.entities] == \
        [e.name for e in jdb.schema.entities]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_matches(seed):
    jdb = tiny_db(seed)
    tdb = to_port(jdb)
    for jp in jc.build_lattice(jdb.schema, 2):
        keep = jp.all_ct_vars(jdb.schema, include_rind=True)
        want = jax_oracle_ct(jdb, jp, keep)
        got = torch_oracle_ct(tdb, point_to_port(jp), keep_to_port(keep))
        np.testing.assert_array_equal(got, want)


# ----------------------------------------------------- import boundary ----

def test_port_imports_without_jax_or_repro():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(SRC / "repro_torch")
                                  .with_suffix("").parts)
        for p in (SRC / "repro_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') "
            "for k, v in sys.modules.items() if v is not None)\n"
            "print('ok', len(" + repr(mods) + "))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_imports_neither_jax_nor_repro():
    """``chip_smoke.py`` imports the port inside ``main`` only, so its
    import statements are read from the source, wherever they stand."""
    tree = ast.parse((SRC.parent / "chip_smoke.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    tops = {name.split(".")[0] for name in names}
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "repro"}, tops


# -------------------------------------------------------------- device ----

def test_entry_points_refuse_default_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    db = tc.paper_benchmark_db("UW", seed=0, scale=0.1)
    calls = [lambda: tc.make_strategy("HYBRID"),
             lambda: tc.make_executor("sparse"),
             lambda: tc.CountingEngine(db, "dense"),
             lambda: tc.discover_model(
                 db, tc.make_strategy("HYBRID", device=CPU))]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_discover_model_rejects_a_strategy_on_another_device():
    db = tc.paper_benchmark_db("UW", seed=0, scale=0.1)
    st = tc.make_strategy("HYBRID", device=CPU)
    with pytest.raises(ValueError):
        tc.discover_model(db, st, device="meta")


def test_wrappers_take_plain_version_for_cpu_tensors():
    ops.reset_counts()
    seg = torch.tensor([0, 2, 2, 5, -1], dtype=torch.int32)
    w = torch.ones(5)
    assert ops.segsum_ones(seg, w, 3).tolist() == [1.0, 0.0, 2.0]
    rows = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    assert ops.segsum_rows(seg, rows, 3).tolist() == [[0, 1], [0, 0], [6, 8]]
    x = torch.tensor([[[10.0], [3.0]]])
    assert ops.mobius(x).reshape(-1).tolist() == [7.0, 3.0]
    assert ops.bdeu(torch.ones(2, 3, 2), 1.0).shape == (2,)
    assert ops.segment_hist(seg, rows, 3).tolist() == [[0, 1], [0, 0],
                                                       [6, 8]]
    qkv = torch.ones(1, 3, 2, 4)
    assert ops.flash_attention(qkv, qkv, qkv).tolist() == qkv.tolist()
    col = torch.tensor([2, 0, 1], dtype=torch.int32)
    part = IdPart(3, col, col, (col,))
    ids, gidx = ops.hop_ids([part, part], (3,), (True,), 9, 3, 3,
                            device=torch.device("cpu"))
    assert ids.tolist() == [7, 2, 3, 16, 11, 12]
    assert gidx.tolist() == [2, 0, 1, 5, 3, 4]
    assert ops.PLAIN_CALLS == {k: 1 for k in ops.KERNELS}
    assert ops.LAUNCHES == {k: 0 for k in ops.KERNELS}


def test_wrappers_refuse_other_devices():
    seg = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ops.segsum_ones(seg, torch.ones(3, device="meta"), 2)
    with pytest.raises(ValueError):
        ops.segsum_ones(torch.zeros(3, dtype=torch.int32),
                        torch.ones(3, device="meta"), 2)
