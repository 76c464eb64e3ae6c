"""The numbers that decide ``correct``, each held to its limit.

* ``table_gap``: the widest gap between a count the program returned and
  the reference's, as a share of the reference's count (or of 1 where
  that is 0).  Float32 counts past 2^24 round by a few units in their
  last place whatever the order of operations: a relative gap, and not an
  exact comparison, is what they meet.
* ``score_gap``: the widest gap between a BDeu score the program's search
  used (or a model's total) and the reference's BDeu of the reference's
  table of that family, as a share of the score's scale: the sum of the
  magnitudes of the log-gamma terms it adds up.  Those terms cancel to a
  score far smaller than them where a child depends strongly on its
  parents, and float32 rounds each term, not their sum.
* ``choice_gap``: how far a structure the search chose falls short of a
  local optimum under the reference's scores: the best gain any legal
  single-edge move would make, as a share of the structure's scale (0
  where no move gains).  Families whose scores tie to float32 rounding
  can flip either way, so a gain that small is not a wrong choice.

The limits are a configuration's (``limits`` in ``configs/<name>.json``),
set from the readings ``perfbench/readings.py`` takes of the program on a
dozen seeds and of its lower-precision control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping

import numpy as np
import torch


def table_gap(got: np.ndarray, want: torch.Tensor) -> float:
    """Widest relative gap of one table (``got`` from the program,
    ``want`` from the reference, same axes and order)."""
    want = want.detach().to("cpu", torch.float64).numpy()
    if got.shape != want.shape:
        return math.inf
    diff = np.abs(got.astype(np.float64) - want)
    return float((diff / np.maximum(np.abs(want), 1.0)).max(initial=0.0))


def score_gap(got: float, want: float, scale: float) -> float:
    """Gap of one score, as a share of the reference's ``scale`` (the sum
    of the magnitudes of the terms it adds up)."""
    if not math.isfinite(got):
        return math.inf
    return abs(got - want) / max(scale, 1.0)


class Verdict:
    """The worst reading of each number, and whatever else went wrong."""

    def __init__(self, limits: Mapping[str, float]):
        self.limits = dict(limits)
        self.worst: Dict[str, float] = {}
        self.faults: List[str] = []

    def read(self, name: str, value: float) -> None:
        if name not in self.limits:
            raise KeyError(f"no limit for {name!r}")
        if math.isnan(value):
            value = math.inf
        self.worst[name] = max(self.worst.get(name, 0.0), value)

    def fault(self, what: str) -> None:
        self.faults.append(what)

    @property
    def correct(self) -> bool:
        return (not self.faults and bool(self.worst)
                and all(v <= self.limits[k] for k, v in self.worst.items()))

    def checks(self) -> dict:
        """Each number beside its limit (the result line's last key)."""
        out = {k: {"value": v, "limit": self.limits[k]}
               for k, v in sorted(self.worst.items())}
        if self.faults:
            out["faults"] = {"value": len(self.faults), "limit": 0}
        return out

    def lines(self) -> List[str]:
        out = [f"fault: {f}" for f in self.faults[:20]]
        out += [f"{k} {v!r} limit {self.limits[k]!r}"
                for k, v in sorted(self.worst.items())]
        out.append(f"correct {self.correct}")
        return out
