"""The sparse executor's segment ids built on the device (the id kernel,
``ops.hop_ids``) from its device copies of the database.

``HostIdsExecutor`` keeps the host's NumPy arithmetic that built those
ids before, as the reference: each hop's segment ids and dense gather
indices and each root's codes computed on the host and copied to the
device per call.  The sparse executor must give the same ids and the same
tables bit for bit, on the CPU through the kernel's plain version and,
where a CUDA card is present, through the kernel itself (those cases skip
without a card).  Then the copies' validity across writes, their bound,
and a small VisualGenome discovery against the reference's.

No JAX here: the card cases run in this file on the chip.
"""

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core import executors as tex
from repro_torch.core.oracle import oracle_ct
from repro_torch.core.plan import compile_plan
from repro_torch.kernels import ops
from repro_torch.kernels.segsum import (IdPart, hop_ids_table,
                                        hop_ids_table_bytes)
from repro_torch.obs import profile

CPU = "cpu"


def np_codes(cols, cards) -> np.ndarray:
    code = np.zeros(len(cols[0]) if cols else 0, dtype=np.int64)
    for col, card in zip(cols, cards):
        code = code * card + col.astype(np.int64)
    return code


def host_code(db, etype, svars) -> np.ndarray:
    """An entity type's int32 mixed-radix code over ``svars`` (zeros for
    none)."""
    tab = db.entities[etype]
    if not svars:
        return np.zeros(tab.size, dtype=np.int32)
    return np_codes([np.asarray(tab.attrs[cv.owner[1]]) for cv in svars],
                    [cv.card for cv in svars]).astype(np.int32)


class HostIdsExecutor(tex.SparseExecutor):
    """The sparse executor with its ids computed on the host in NumPy and
    copied to the device on every call."""

    def _hop_ids(self, dbs, hops, msg, parts, n_parent, stats):
        idx = [tex._hop_indices(db, h.atom, h.child, h.parent)
               for db, h in zip(dbs, hops)]
        ds = int(np.prod(msg.cards, dtype=np.int64))
        for cv in hops[0].edge_attrs:
            ds *= cv.card
        total = n_parent * ds
        if total > tex._INT32_LIMIT:
            raise OverflowError(total)
        sizes = [int(np.asarray(g).shape[0]) for _, g, _, _ in idx]
        seg_np = np.empty(sum(sizes), dtype=np.int32)
        out_vars, off = [], 0
        for i, (db, hop, (rt, g, s, _), n) in enumerate(
                zip(dbs, hops, idx, sizes)):
            seg = seg_np[off:off + n]
            off += n
            np.multiply(s, ds, out=seg, casting="unsafe")
            ecode = (None if not msg.svars[i] else
                     host_code(db, hop.child.etype, msg.svars[i])[
                         np.asarray(g)])
            svars = tuple(msg.svars[i])
            for cv in hop.edge_attrs:
                col = np.asarray(rt.attrs[cv.owner[1]], dtype=np.int32)
                ecode = col if ecode is None else ecode * cv.card + col
                svars = svars + (cv,)
            if ecode is not None:
                seg += ecode
            if i:
                seg += i * total
            out_vars.append(svars if msg.dense is None
                            else svars + tuple(msg.dvars[i]))
            if stats[i] is not None:
                stats[i].joins += 1
                stats[i].rows_scanned += n
        gathers = None if msg.dense is None else self._upload(
            tex._end_to_end([g for _, g, _, _ in idx],
                            dbs[0].entities[hops[0].child.etype].size))
        return self._upload(seg_np), gathers, ds, total, out_vars

    def _codes(self, dbs, fss, step):
        return self._upload(tex._end_to_end(
            [host_code(db, fs.var.etype, fs.attrs)
             for db, fs in zip(dbs, fss)], step))


def recorded(ex) -> list:
    """Keep every id tensor ``ex``'s hops and roots produce, with each
    hop group's plan count."""
    seen, hop_ids, codes = [], ex._hop_ids, ex._codes

    def hop(dbs, hops, msg, parts, n_parent, stats):
        out = hop_ids(dbs, hops, msg, parts, n_parent, stats)
        seen.append((len(hops), out[0].cpu().clone(),
                     None if out[1] is None else out[1].cpu().clone()))
        return out

    def code(dbs, fss, step):
        out = codes(dbs, fss, step)
        seen.append((len(fss), out.cpu().clone(), None))
        return out
    ex._hop_ids, ex._codes = hop, code
    return seen


def points_of(db, atoms: int, n: int, same_key: bool):
    """``n`` lattice points of ``atoms`` atoms (one stack key if
    ``same_key``), each with every attribute kept."""
    pts = [p for p in tc.build_lattice(db.schema, atoms)
           if len(p.atoms) == atoms]
    plans = [compile_plan(db.schema, p, p.all_ct_vars(
        db.schema, include_rind=False)) for p in pts]
    if not same_key:
        return plans[:n]
    groups: dict = {}
    for plan in plans:
        groups.setdefault(tex.plan_stack_key(db, plan), []).append(plan)
    best = max(groups.values(), key=len)
    assert len(best) >= n
    return best[:n]


def imdb(seed=0):
    return tc.paper_benchmark_db("IMDb", seed=seed, scale=0.001)


def vg(seed=0):
    return tc.paper_benchmark_db("VisualGenome", seed=seed, scale=0.0005)


def case_leaf(keep_codes: bool):
    db = imdb()
    point = tc.build_lattice(db.schema, 1)[0]
    keep = ()
    if keep_codes:       # the child's attributes, not the root's or edge's
        plan = compile_plan(db.schema, point, point.all_ct_vars(
            db.schema, include_rind=False))
        child = plan.root.hops[0].child
        keep = tuple(cv for cv in point.all_ct_vars(db.schema,
                                                     include_rind=False)
                     if cv.owner[0] == child.etype)
    return [db], [compile_plan(db.schema, point, keep)], 1


def case_edge_attrs():
    db = vg()
    return [db] * 3, points_of(db, 1, 3, True), 3


def case_dense():
    db = vg()
    return [db] * 7, points_of(db, 3, 7, True), 7


def case_two_databases():
    a, b = vg(0), vg(1)
    plans = points_of(a, 2, 2, True)
    return [a, a, b, b], plans + plans, 4


def case_empty_relation():
    db = imdb()
    rt = db.relations["imdb_R2"]
    db.delete_facts("imdb_R2", rt.src.copy(), rt.dst.copy())
    assert db.relations["imdb_R2"].num_edges == 0
    plans = [p for p in points_of(db, 2, 99, False)
             if any(a.rel == "imdb_R2" for a in p.point.atoms)]
    return [db] * len(plans), plans, 1


CASES = {"leaf_no_codes": lambda: case_leaf(False),
         "leaf_codes": lambda: case_leaf(True),
         "edge_attrs_b3": case_edge_attrs,
         "dense_b7": case_dense,
         "two_databases": case_two_databases,
         "empty_relation": case_empty_relation}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_device_ids_match_host_arithmetic(case, device):
    """Every hop's segment ids and gather indices and every root's codes,
    and every table, equal the host arithmetic's bit for bit."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the id kernel runs only there")
    dbs, plans, b = CASES[case]()
    ex, ref = (tex.SparseExecutor(device=device),
               HostIdsExecutor(device=device))
    got, want = recorded(ex), recorded(ref)
    ops.reset_counts()
    tabs = ex.positive_batch_multi(dbs, plans)
    calls = (ops.LAUNCHES if device == "cuda" else ops.PLAIN_CALLS)[
        "hop_ids"]
    ref_tabs = ref.positive_batch_multi(dbs, plans)
    # on the card a call with no ids launches nothing
    assert calls == sum(1 for _, seg, _ in got
                        if device == "cpu" or seg.numel()) > 0
    assert len(got) == len(want)
    for (nb, seg, gidx), (rb, rseg, rgidx) in zip(got, want):
        assert nb == rb
        assert seg.dtype == torch.int32 and torch.equal(seg, rseg)
        assert (gidx is None) == (rgidx is None)
        if gidx is not None:
            assert gidx.dtype == torch.int32 and torch.equal(gidx, rgidx)
    assert max(nb for nb, _, _ in got) == b
    if case == "dense_b7":
        assert any(gidx is not None for _, _, gidx in got)
    if case == "empty_relation":
        assert any(seg.numel() == 0 for _, seg, _ in got)
    for tab, rtab in zip(tabs, ref_tabs):
        assert tab.vars == rtab.vars
        assert torch.equal(tab.counts, rtab.counts)


@pytest.mark.parametrize("plans,cols", [(1, 0), (3, 2), (7, 5)])
def test_argument_table_bytes(plans, cols):
    """The argument table the executor's ``exec.host_ids`` span reports
    (``args_bytes``) is the table the wrapper sends to the card."""
    col = torch.zeros(4, dtype=torch.int32)
    parts = [IdPart(4, col, col, (col,) * cols)] * plans
    table = hop_ids_table(parts, (2,) * cols, (True,) * cols)
    assert table.dtype == np.int64
    assert table.nbytes == hop_ids_table_bytes(plans, cols)


# ------------------------------------------------------- the copies ----

def _reads(db, plan):
    """Every column read of one evaluation of ``plan`` (repeats kept)."""
    stack = [plan.root]
    while stack:
        n = stack.pop()
        tab = db.entities[n.var.etype]
        for cv in n.own.attrs:
            yield tab.attrs[cv.owner[1]]
        for h in n.hops:
            stack.append(h.child_node)
            rt, g, s, _ = tex._hop_indices(db, h.atom, h.child, h.parent)
            yield g
            yield s
            for cv in h.edge_attrs:
                yield rt.attrs[cv.owner[1]]


def arrays_read(db, plan) -> dict:
    """The database columns one evaluation of ``plan`` reads, by id."""
    return {id(a): a for a in _reads(db, plan)}


def test_resident_copies_follow_writes():
    """One executor counts a pattern before and after each kind of write:
    each table equals a fresh executor's and the oracle's; each array is
    copied once and read from its copy on every later hop."""
    db = tc.paper_benchmark_db("UW", seed=3, scale=0.05)
    point = next(p for p in tc.build_lattice(db.schema, 2)
                 if len(p.atoms) == 2)
    keep = tuple(point.all_ct_vars(db.schema, include_rind=False))
    plan = compile_plan(db.schema, point, keep)
    ex = tc.SparseExecutor(device=CPU)
    rng = np.random.default_rng(0)
    seen: dict = {}     # every array copied so far, held so ids stay unique

    def count(view):
        """Count on ``view``: the arrays not seen before are copied."""
        read = arrays_read(view, plan)
        new = [k for k, a in read.items() if seen.get(k) is not a]
        builds, hits = ex.resident_builds, ex.resident_hits
        tab = ex.positive(view, plan)
        assert ex.resident_builds - builds == len(new)
        assert ex.resident_hits - hits == sum(
            1 for _ in _reads(view, plan)) - len(new)
        seen.update(read)
        fresh = tc.SparseExecutor(device=CPU).positive(view, plan)
        assert torch.equal(tab.counts, fresh.counts)
        np.testing.assert_array_equal(
            tab.counts.numpy(), oracle_ct(view, point, keep,
                                          require_positive=True))
        builds = ex.resident_builds
        ex.positive(view, plan)                     # all hits now
        assert ex.resident_builds == builds
        return len(new)

    assert count(db) == len(arrays_read(db, plan))
    etype = point.vars[0].etype
    attr = db.schema.entity(etype).attrs[0]
    rows = np.arange(3)
    db.update_attrs(etype, rows, {attr.name: (np.asarray(
        db.entities[etype].attrs[attr.name][rows]) + 1) % attr.card})
    assert count(db) == 1                           # the written column
    rel = point.atoms[0].rel
    rt = db.relations[rel]
    ns = db.entities[rt.type.src].size
    nd = db.entities[rt.type.dst].size
    have = set(zip(rt.src.tolist(), rt.dst.tolist()))
    new = [(s, d) for s in range(ns) for d in range(nd)
           if (s, d) not in have][:4]
    delta = db.insert_facts(rel, [s for s, _ in new], [d for _, d in new],
                            {a.name: rng.integers(0, a.card, len(new))
                             for a in rt.type.attrs})
    count(db)
    view = delta.as_db(db)
    assert count(view) == sum(                      # the delta's own arrays
        1 for a in arrays_read(view, plan).values()
        if any(a is x for x in (delta.src, delta.dst,
                                *delta.attrs.values())))
    db.delete_facts(rel, db.relations[rel].src[:2].copy(),
                    db.relations[rel].dst[:2].copy())
    count(db)


def test_resident_copies_of_replaced_arrays_go():
    """Many writes through one executor leave it holding one copy of each
    live array: the copies of the columns a write replaced are gone."""
    db = tc.paper_benchmark_db("UW", seed=4, scale=0.05)
    point = next(p for p in tc.build_lattice(db.schema, 2)
                 if len(p.atoms) == 2)
    keep = tuple(point.all_ct_vars(db.schema, include_rind=False))
    plan = compile_plan(db.schema, point, keep)
    ex = tc.SparseExecutor(device=CPU)
    etype = point.vars[0].etype
    attr = db.schema.entity(etype).attrs[0]
    rel = point.atoms[0].rel
    rng = np.random.default_rng(1)

    def live_bytes():
        return sum(int(a.nbytes) for a in arrays_read(db, plan).values())
    ex.positive(db, plan)
    one_version = live_bytes()
    assert ex._copies_bytes == one_version
    for i in range(20):
        rows = rng.choice(db.entities[etype].size, 3, replace=False)
        db.update_attrs(etype, rows, {attr.name: rng.integers(
            0, attr.card, 3)})
        if i % 5 == 4:          # and a delete, then its edges back
            rt = db.relations[rel]
            src, dst = rt.src[:2].copy(), rt.dst[:2].copy()
            vals = {k: v[:2].copy() for k, v in rt.attrs.items()}
            db.delete_facts(rel, src, dst)
            db.insert_facts(rel, src, dst, vals)
        tab = ex.positive(db, plan)
        assert ex._copies_bytes == live_bytes() == one_version
        assert len(ex._copies) == len(arrays_read(db, plan))
    np.testing.assert_array_equal(
        tab.counts.numpy(), oracle_ct(db, point, keep,
                                      require_positive=True))


def test_resident_copies_stay_under_their_limit():
    """Past the byte limit the least recently read copies go, and the
    tables do not change."""
    dbs = [tc.paper_benchmark_db("UW", seed=s, scale=0.2) for s in range(3)]
    point = tc.build_lattice(dbs[0].schema, 1)[0]
    plan = compile_plan(dbs[0].schema, point, point.all_ct_vars(
        dbs[0].schema, include_rind=False))
    ex = tc.SparseExecutor(device=CPU)
    ex.positive(dbs[0], plan)
    one_db = ex._copies_bytes
    ex._copies_limit = one_db
    tabs = [ex.positive(db, plan) for db in dbs]
    assert ex._copies_bytes <= one_db
    assert set(ex._copies) == set(arrays_read(dbs[-1], plan))
    for db, tab in zip(dbs, tabs):
        fresh = tc.SparseExecutor(device=CPU).positive(db, plan)
        assert torch.equal(tab.counts, fresh.counts)


def test_resident_copies_under_threads():
    """Threads counting through one executor at once (a short switch
    interval) lose no count and no copy: every read is a build or a hit,
    the bytes are the entries', and every table is the lone thread's."""
    import sys
    import threading
    dbs = [tc.paper_benchmark_db("UW", seed=s, scale=0.1) for s in range(4)]
    point = tc.build_lattice(dbs[0].schema, 1)[0]
    plan = compile_plan(dbs[0].schema, point, point.all_ct_vars(
        dbs[0].schema, include_rind=False))
    want = [tc.SparseExecutor(device=CPU).positive(db, plan) for db in dbs]
    ex = tc.SparseExecutor(device=CPU)
    reads = sum(1 for _ in _reads(dbs[0], plan))
    rounds, errors = 12, []

    def work(k):
        try:
            for r in range(rounds):
                i = (k + r) % len(dbs)
                if not torch.equal(ex.positive(dbs[i], plan).counts,
                                   want[i].counts):
                    errors.append((k, r))
        except Exception as err:          # noqa: BLE001 — asserted below
            errors.append(err)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert ex.resident_builds + ex.resident_hits == 8 * rounds * reads
    assert ex.resident_builds >= len(ex._copies) == sum(
        len(arrays_read(db, plan)) for db in dbs)
    assert all(ref() is not None for ref, _ in ex._copies.values())


def test_visualgenome_discovery_equals_host_ids():
    """A small VisualGenome HYBRID discovery on the device ids and on the
    host's: the same families, bit for bit, the same scores and the same
    models; the copies' ``exec.upload`` bytes are the columns' bytes."""
    db = vg(2)
    runs = []
    tracer = profile.profiled_tracer()
    for ex in (tex.SparseExecutor(device=CPU), HostIdsExecutor(device=CPU)):
        tracer.clear()
        strategy = tc.make_strategy("HYBRID", executor=ex, device=CPU)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            models, st = tc.discover_model(db, strategy, max_chain_length=3,
                                           device=CPU)
        cache = st.engine.cache
        fams = {k: cache.peek(k) for k in cache.keys_snapshot()
                if k[0] == "fam"}
        uploads = [r.attrs for r in tracer.records()
                   if r.name == "exec.upload"]
        runs.append((models, fams, uploads, ex))
    (models, fams, uploads, ex), (rmodels, rfams, _, _) = runs
    assert fams.keys() == rfams.keys() and len(fams) > 0
    for k, tab in fams.items():
        assert tab.vars == rfams[k].vars
        assert torch.equal(tab.counts, rfams[k].counts), k
    assert models.keys() == rmodels.keys()
    for p, m in models.items():
        assert m.parents == rmodels[p].parents
        assert m.score == rmodels[p].score
    columns = sum(int(a.nbytes) for t in db.relations.values()
                  for a in (t.src, t.dst, *t.attrs.values()))
    columns += sum(int(a.nbytes) for t in db.entities.values()
                   for a in t.attrs.values())
    assert all(u.get("what") == "resident" for u in uploads)
    assert sum(u["bytes"] for u in uploads) == columns == ex._copies_bytes
    assert ex.resident_builds == len(uploads)
