"""The ``discover_tpch`` kind: the ``discover`` kind (``kinds/discover.py``:
one analyst, closed loop, cold discovery after cold discovery, one of
them checked) over TPC-H's database, drawn by :mod:`perfbench.tpch`'s
rules in place of :mod:`perfbench.synth`'s arithmetic."""

from __future__ import annotations

import time
from pathlib import Path

from perfbench import tpch
from perfbench.generator import build_db
from perfbench.harness import mix_class

DiscoverMix = mix_class("discover", Path(__file__).resolve().parents[1])


class TpchDiscoverMix(DiscoverMix):

    def setup(self) -> None:
        self.tables, self.models, self.scores = [], {}, {}
        t0 = time.perf_counter()
        self.arrays = tpch.generate(self.cfg, self.ctx.seed, self.ctx.scale)
        t1 = time.perf_counter()
        self.db = build_db(self.cfg, self.arrays)
        t2 = time.perf_counter()
        self._discover()                  # warms every shape of the path
        self.notes.append(f"set-up: generate {t1 - t0:.3f} s, database "
                          f"{t2 - t1:.3f} s, warm discovery "
                          f"{time.perf_counter() - t2:.3f} s")


MIX = TpchDiscoverMix
