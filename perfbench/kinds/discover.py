"""The ``discover`` kind: one analyst, closed loop, cold discovery after
cold discovery.

Each discovery is ``discover_model`` with a fresh strategy (the traffic
file's ``strategy``, on the configuration's executor and counting type),
so pre-counting is inside each discovery, as the paper times it.  The
window closes at the end of the first discovery that ends after
``seconds``: every discovery in it is whole, and ``discovery_s`` is the
window's length over their number.  One discovery of the window, drawn
from the seed, is checked: ``check_tables`` of its family tables, every
family score its search used, each model's total, and each model's
choice against every legal single-edge move.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from perfbench import compare, synth
from perfbench.generator import (Mix, axis_of, build_db, host_table,
                                 rels_of)
from perfbench.reference import Axis, Reference, bdeu


class DiscoverMix(Mix):
    e2e_name = "discovery_s"

    def setup(self) -> None:
        self.tables, self.models, self.scores = [], {}, {}
        t0 = time.perf_counter()
        self.arrays = synth.generate(self.cfg, self.ctx.seed, self.ctx.scale)
        t1 = time.perf_counter()
        self.db = build_db(self.cfg, self.arrays)
        t2 = time.perf_counter()
        self._discover()                  # warms every shape of the path
        self.notes.append(f"set-up: generate {t1 - t0:.3f} s, database "
                          f"{t2 - t1:.3f} s, warm discovery "
                          f"{time.perf_counter() - t2:.3f} s")

    def _discover(self):
        from repro_torch.core import discover_model
        s = self.search_cfg
        return discover_model(self.db, self.make_strategy(),
                              max_chain_length=s["max_chain_length"],
                              max_parents=s["max_parents"], ess=s["ess"],
                              device=self.ctx.device)

    def window(self, seconds: float) -> None:
        import repro_torch.core.search as search_mod
        plain = search_mod.StructureSearch
        made: List[object] = []

        class Recorded(plain):
            """The search ``discover_model`` builds, kept for reading."""

            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                made.append(self)

        search_mod.StructureSearch = Recorded
        families, positive, negative, each = [], [], [], []
        self.kept = None
        try:
            t0 = time.perf_counter()
            while True:
                made.clear()
                self.attempted += 1
                began = time.perf_counter()
                try:
                    models, strategy = self._discover()
                except Exception as err:          # noqa: BLE001 — reported
                    self.failed += 1              # as a failed discovery
                    self.errors.append(f"discovery failed: {err!r}")
                    break
                each.append(time.perf_counter() - began)
                families.append(made[-1].families_scored)
                positive.append(strategy.stats.time_positive)
                negative.append(strategy.stats.time_negative)
                if self.ctx.rng.random() * len(families) < 1.0:
                    # a uniform sample of one discovery of the window
                    self.kept = (models, strategy, made[-1])
                if time.perf_counter() - t0 >= seconds:
                    break
            self.ctx.sync()
            elapsed = time.perf_counter() - t0
        finally:
            search_mod.StructureSearch = plain
        done = max(1, len(families))
        self.e2e = elapsed / done
        q = np.quantile(each, [0.0, 0.25, 0.5, 0.75, 1.0]) if each else []
        self.notes.append(f"window: {len(families)} whole discoveries in "
                          f"{elapsed!r} s; each (min, quartiles, max) "
                          f"{[round(float(v), 4) for v in q]} s")
        self.records.update(window_s=elapsed, units=len(families),
                            families=families, positive_s=positive,
                            negative_s=negative)

    def collect(self) -> None:
        """The sampled discovery's answers, on the host (:meth:`take`)."""
        if self.kept is None:
            return
        from repro_torch.core import LatticePoint
        models, strategy, search = self.kept
        cache = strategy.engine.cache
        fams = [(LatticePoint(k[1]), cache.peek(k))
                for k in cache.keys_snapshot() if k[0] == "fam"]
        self.take(models, fams, search)
        del self.kept, models, strategy, search, fams

    def take(self, models, fams, search) -> None:
        """Keep what a discovery answered: a seeded sample of its family
        tables ``fams`` (``(point, table)``), every family score its
        ``search`` used, with the point it was scored at, and its models."""
        fams = sorted(fams, key=lambda f: repr((f[0].atoms, f[1].vars)))
        n_tables = min(int(self.traffic["check_tables"]), len(fams))
        pick = self.ctx.rng.choice(len(fams), size=n_tables, replace=False)
        for i in sorted(pick):
            point, tab = fams[i]
            axes, counts = host_table(tab)
            self.tables.append((rels_of(point), axes, counts))
        for point, model in models.items():
            nodes = [axis_of(n) for n in model.nodes]
            parents = {axis_of(c): frozenset(axis_of(p) for p in ps)
                       for c, ps in model.parents.items()}
            self.models[rels_of(point)] = (nodes, parents, model.score)
        deps = search.family_deps
        for (child, ps), score in search._score_cache.items():
            key = (axis_of(child), frozenset(axis_of(p) for p in ps))
            self.scores[key] = (tuple(sorted(deps[(child, ps)])),
                                float(score))

    def run_control(self, seconds: float, low) -> None:
        """The control in the program's place: the program's search over
        the lower-precision reference's family tables (``low``, a
        :class:`Reference` or :class:`Rounded`), then :meth:`take`."""
        from repro_torch.core import StructureSearch, build_lattice
        from repro_torch.core.ct import CtTable
        served = []

        class Counts:
            def family_ct(self, point, keep):
                t = low.family(rels_of(point), [axis_of(v) for v in keep])
                tab = CtTable(tuple(keep), t.to(torch.float32))
                served.append((point, tab))
                return tab

        s = self.search_cfg
        search = StructureSearch(None, None, max_parents=s["max_parents"],
                                 ess=s["ess"], counts=Counts(),
                                 schema=self.db.schema)
        models = search.run(build_lattice(self.db.schema,
                                          s["max_chain_length"]))
        self.attempted = 1
        self.take(models, served, search)

    def check(self, verdict: compare.Verdict, ref: Reference) -> None:
        if not self.models:
            verdict.fault("no discovery finished")
        for rels, axes, got in self.tables:
            verdict.read("table_gap",
                         compare.table_gap(got, ref.family(rels, axes)))
        ess = self.search_cfg["ess"]
        memo: Dict[Tuple, Tuple[float, float]] = {}

        def ref_score(child: Axis, ps: frozenset):
            """The reference's (score, scale) of a family, at the point
            whose table the search scored it from."""
            key = (child, ps)
            if key not in self.scores:
                verdict.fault(f"family {child} | {sorted(ps)} was not "
                              f"scored by the search")
                return None
            if key not in memo:
                rels, got = self.scores[key]
                memo[key] = bdeu(ref.family(rels, sorted(ps) + [child]), ess)
                verdict.read("score_gap", compare.score_gap(got, *memo[key]))
            return memo[key]

        most = self.search_cfg["max_parents"]
        for rels, (nodes, parents, total) in sorted(self.models.items()):
            here = [ref_score(c, parents[c]) for c in nodes]
            if None in here:
                continue
            want = sum(s for s, _ in here)
            scale = sum(m for _, m in here)
            verdict.read("score_gap", compare.score_gap(total, want, scale))
            best = 0.0
            for src, dst in itertools.permutations(nodes, 2):
                if src in parents[dst]:
                    new = parents[dst] - {src}
                elif (len(parents[dst]) >= most
                      or _ancestor(parents, dst, src)):
                    continue
                else:
                    new = parents[dst] | {src}
                moved = ref_score(dst, new)
                if moved is not None:
                    best = max(best, moved[0] - ref_score(dst,
                                                          parents[dst])[0])
            verdict.read("choice_gap", best / max(scale, 1.0))


def _ancestor(parents: Mapping, node, of) -> bool:
    """Is ``node`` an ancestor of ``of`` (or ``of`` itself)?"""
    stack, seen = [of], set()
    while stack:
        n = stack.pop()
        if n == node:
            return True
        if n not in seen:
            seen.add(n)
            stack.extend(parents[n])
    return False


MIX = DiscoverMix
