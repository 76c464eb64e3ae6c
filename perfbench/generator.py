"""What every traffic kind shares: the context a mix is given, the
program's database built from the benchmark's arrays, the reference's
names for the program's table axes, and the :class:`Mix` interface.

A cell's traffic is a data file, ``traffic/<mix>.json``: its ``kind``
names the code that drives the program, ``kinds/<kind>.py``, which the
harness loads by path, as it loads a metric's reader; every other key is
that kind's parameters.  A kind module defines ``MIX``, a subclass of
:class:`Mix`.  A later cell with a new kind of traffic (writes, a router,
tenants) adds its kind's file and its traffic file, and edits neither
this module nor the harness.

Each mix keeps, from a sample drawn from the seed, what the program
answered, frees the program, and hands the answers to the reference
(:meth:`Mix.check`).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from . import synth
from .reference import Axis


class Context:
    """What a mix is given: the configuration and traffic files, the
    seed, the device and (for tests) a scale of the configuration."""

    def __init__(self, cfg: Mapping, traffic: Mapping, seed: int,
                 device: str, scale: float = 1.0):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device, self.scale = device, scale
        self.rng = synth.stream(self.seed, 0xFFFF)     # the sample's draws

    def sync(self) -> None:
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()


def axis_of(ctvar) -> Axis:
    """The reference's name for one of the program's table axes."""
    if ctvar.kind == "attr":
        var, name = ctvar.owner
        return Axis("attr", (var.etype, var.copy, name), ctvar.card)
    if ctvar.kind == "edge":
        return Axis("edge", tuple(ctvar.owner), ctvar.card)
    return Axis("rind", tuple(ctvar.owner), 2)


def rels_of(point) -> Tuple[str, ...]:
    return tuple(sorted(a.rel for a in point.atoms))


def build_db(cfg: Mapping, arrays: synth.Arrays):
    """The program's database from the arrays, by its public constructor."""
    from repro_torch.core import db_from_arrays
    return db_from_arrays(synth.schema_spec(cfg, arrays),
                          arrays["entities"], arrays["relations"])


def host_table(tab) -> Tuple[List[Axis], np.ndarray]:
    return ([axis_of(v) for v in tab.vars],
            tab.counts.detach().to("cpu", torch.float64).numpy())


class Mix:
    """One cell's traffic.  A kind implements:

    * ``setup()``: make ``self.arrays`` (:func:`perfbench.synth.generate`)
      and the program's state, and warm every shape the window uses;
    * ``window(seconds)``: drive the program for the measured window; set
      ``self.e2e`` (the end-to-end metric named ``e2e_name``),
      ``self.attempted`` and ``self.failed``, and put what the per-layer
      readers read into ``self.records`` (``window_s`` and ``units`` at
      least);
    * ``collect()``: after the window, keep the sampled answers on the
      host and free the program's state;
    * ``run_control(seconds, low)``: the lower-precision reference ``low``
      in the program's place (``perfbench/readings.py`` only);
    * ``check(verdict, ref)``: read each number of ``correct`` against the
      reference ``ref`` into ``verdict``.
    """

    e2e_name = ""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.cfg, self.traffic = ctx.cfg, ctx.traffic
        self.search_cfg = ctx.cfg["search"]
        self.dtype = getattr(torch, ctx.cfg["counts_dtype"])
        self.arrays: Optional[synth.Arrays] = None
        self.attempted = self.failed = 0
        self.errors: List[str] = []
        self.notes: List[str] = []
        self.records: Dict[str, object] = {}
        self.e2e = 0.0

    def make_strategy(self):
        from repro_torch.core import make_strategy
        return make_strategy(self.traffic["strategy"],
                             executor=self.cfg["executor"],
                             dtype=self.dtype, device=self.ctx.device)
