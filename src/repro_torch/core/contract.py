"""Cost instrumentation + one-hot contraction primitives.

The engine lives in three layers —

* :mod:`repro_torch.core.plan`       compiles ``(LatticePoint, keep)`` queries,
* :mod:`repro_torch.core.executors`  evaluates plans (dense one-hot / sparse
  segment-sum backends),
* :mod:`repro_torch.core.cache`      budgeted LRU storage for every ct artefact —

and this module keeps what the whole stack shares: the paper-metric
instrumentation (:class:`CostStats`: Fig. 3 time decomposition, Fig. 4
memory proxy, Table 5 ct sizes), the dense one-hot helpers used by the
dense executor, and thin compatibility wrappers (:func:`positive_ct`,
:func:`entity_hist`) that compile + execute on the dense backend.

Each dense hop is ``gather → (outer) multiply → segment-sum``.  Complexity:
O(edges × D) per hop where D is the flattened value-space of the subtree —
the paper's Eq. (3) growth.  The sparse executor replaces this with O(nnz)
scatter-adds; see :mod:`repro_torch.core.executors`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..obs.hist import LatencyHistogram
from .ct import CtTable
from .database import RelationalDB
from .device import resolve_device, synchronize
from .variables import CtVar, LatticePoint, Var, attr_var


@dataclass
class CostStats:
    """Instrumentation mirroring the paper's reported metrics.

    ``cache_bytes`` is the *live* cache footprint: :class:`~repro_torch.core
    .cache.CtCache` bumps it on insert and **decrements it on eviction or
    drop**, so ``peak_bytes`` (the Fig. 4 memory proxy) is a true
    high-water mark even under a byte budget.

    Beyond the Fig. 3 *totals*, each timed phase also feeds a
    log-bucketed :class:`~repro_torch.obs.hist.LatencyHistogram` in
    ``phase_hists`` — per-interval p50/p95/p99 for metadata/positive/
    negative work, surfaced under ``"phases"`` in :meth:`as_dict`.

    ``device`` is the counting device (set by the engine).  On a CUDA
    device the phase timers synchronise on entry and exit, so each phase is
    charged the device time of the work it queued, not just the enqueue.
    """
    joins: int = 0                # number of edge-table join sweeps
    rows_scanned: int = 0         # edge rows touched by joins
    ct_cells: int = 0             # dense ct cells materialised
    ct_rows: int = 0              # sparse-equivalent rows materialised
    cache_bytes: int = 0          # live cache footprint
    peak_bytes: int = 0           # high-water mark (Fig. 4 proxy)
    time_metadata: float = 0.0    # Fig. 3 decomposition
    time_positive: float = 0.0
    time_negative: float = 0.0
    phase_hists: Dict[str, LatencyHistogram] = field(default_factory=dict)
    device: Optional[torch.device] = None

    def bump_cache(self, delta: int) -> None:
        self.cache_bytes += delta
        self.peak_bytes = max(self.peak_bytes, self.cache_bytes)

    def observe_phase(self, which: str, dt: float) -> None:
        h = self.phase_hists.get(which)
        if h is None:
            h = self.phase_hists[which] = LatencyHistogram()
        h.observe(dt)

    def _sync(self) -> None:
        if self.device is not None:
            synchronize(self.device)

    class _Timer:
        def __init__(self, stats: "CostStats", which: str) -> None:
            self.stats, self.which = stats, which

        def __enter__(self):
            self.stats._sync()
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.stats._sync()
            dt = time.perf_counter() - self.t0
            setattr(self.stats, f"time_{self.which}",
                    getattr(self.stats, f"time_{self.which}") + dt)
            self.stats.observe_phase(self.which, dt)

    class _DisjointTimer(_Timer):
        """Time a phase EXCLUDING nested work that times itself into
        another bucket — the Fig. 3 decomposition must stay disjoint
        (e.g. a Möbius join timed as ``negative`` whose cache misses
        re-contract positives that time themselves as ``positive``)."""

        def __init__(self, stats: "CostStats", which: str,
                     nested: str) -> None:
            super().__init__(stats, which)
            self.nested = nested

        def __enter__(self):
            self.nested0 = getattr(self.stats, f"time_{self.nested}")
            return super().__enter__()

        def __exit__(self, *exc):
            super().__exit__(*exc)
            grown = getattr(self.stats, f"time_{self.nested}") - self.nested0
            setattr(self.stats, f"time_{self.which}",
                    getattr(self.stats, f"time_{self.which}") - grown)

    def timer(self, which: str) -> "CostStats._Timer":
        return CostStats._Timer(self, which)

    def disjoint_timer(self, which: str,
                       nested: str = "positive") -> "CostStats._Timer":
        """A :meth:`timer` for ``which`` that subtracts whatever nested
        work added to ``time_<nested>`` while it ran."""
        return CostStats._DisjointTimer(self, which, nested)

    def as_dict(self) -> Dict[str, float]:
        return dict(joins=self.joins, rows_scanned=self.rows_scanned,
                    ct_cells=self.ct_cells, ct_rows=self.ct_rows,
                    cache_bytes=self.cache_bytes, peak_bytes=self.peak_bytes,
                    time_metadata=self.time_metadata,
                    time_positive=self.time_positive,
                    time_negative=self.time_negative,
                    time_total=self.time_metadata + self.time_positive
                    + self.time_negative,
                    phases={k: h.as_dict()
                            for k, h in self.phase_hists.items()})


# --------------------------------------------------------------------------
# one-hot helpers (dense backend)
# --------------------------------------------------------------------------

def _onehot(codes: torch.Tensor, card: int, dtype) -> torch.Tensor:
    return F.one_hot(codes.long(), card).to(dtype)


def _expand(msg: torch.Tensor, mvars: List[CtVar],
            hot: torch.Tensor, hvar: CtVar) -> Tuple[torch.Tensor, List[CtVar]]:
    """(n, D) x (n, V) -> (n, D*V); track flattened axis order (row-major)."""
    n, d = msg.shape
    out = (msg[:, :, None] * hot[:, None, :]).reshape(n, d * hot.shape[1])
    return out, mvars + [hvar]


def entity_onehot(db: RelationalDB, var: Var, keep: Sequence[CtVar],
                  dtype=torch.float32, device=None
                  ) -> Tuple[torch.Tensor, List[CtVar]]:
    """(n_var, D) one-hot product over the kept attributes of ``var``."""
    device = resolve_device(device)
    tab = db.entities[var.etype]
    msg = torch.ones((tab.size, 1), dtype=dtype, device=device)
    mvars: List[CtVar] = []
    for a in tab.type.attrs:
        cv = attr_var(var, a.name, a.card)
        if cv in keep:
            col = torch.from_numpy(np.asarray(tab.attrs[a.name])).to(device)
            msg, mvars = _expand(msg, mvars, _onehot(col, a.card, dtype), cv)
    return msg, mvars


def entity_hist(db: RelationalDB, var: Var, keep: Sequence[CtVar],
                dtype=torch.float32, device=None) -> CtTable:
    """Histogram over kept attributes of one variable (metadata stage).

    With no kept attributes this degenerates to the population size — the
    Cartesian factor for an unconstrained variable."""
    msg, mvars = entity_onehot(db, var, keep, dtype, device)
    flat = torch.sum(msg, dim=0)
    counts = flat.reshape(tuple(v.card for v in mvars)) if mvars else flat[0]
    return CtTable(tuple(mvars), counts)


def _khatri_rao_reduce(factors: List[Tuple[torch.Tensor, List[CtVar]]],
                       max_chunk_cells: int = 32_000_000,
                       batch: Optional[int] = None
                       ) -> Tuple[torch.Tensor, List[CtVar]]:
    """``sum_n  f1[n,:] ⊗ f2[n,:] ⊗ ...`` without materialising the full
    (n, prod D) expansion: the widest factor becomes the right operand of a
    per-chunk matrix product, the rest are Khatri-Rao'd per chunk.

    With ``batch`` the factors' rows are ``batch`` plans' entity rows laid
    end to end (``(batch * n, D)``, plan-major) and the sum runs per plan:
    the result is ``(batch, prod D)``, one flat table per plan, by one
    batched product a chunk.

    Memory is bounded by ``chunk × prod(D_but_widest)`` + the output.  The
    products are float32 sums of integer counts, exact below 2^24 per cell
    (TF32 matrix products would round them: keep
    ``torch.backends.cuda.matmul.allow_tf32`` at its default, False)."""
    factors = [f for f in factors]
    b = 1 if batch is None else batch
    mvars: List[CtVar] = []
    # move the widest factor last; record the resulting axis order
    widest = max(range(len(factors)), key=lambda i: factors[i][0].shape[1])
    order = [i for i in range(len(factors)) if i != widest] + [widest]
    mats = [factors[i][0].reshape(b, -1, factors[i][0].shape[1])
            for i in order]
    for i in order:
        mvars.extend(factors[i][1])
    n = mats[0].shape[1]
    d_left = int(np.prod([m.shape[2] for m in mats[:-1]], dtype=np.int64))
    d_last = mats[-1].shape[2]
    if len(mats) == 1:
        out = torch.sum(mats[0], dim=1)
    else:
        chunk = max(64, min(n, max_chunk_cells // max(b * d_left, 1)))
        out = torch.zeros((b, d_left, d_last), dtype=mats[0].dtype,
                          device=mats[0].device)
        for s in range(0, n, chunk):
            kr = mats[0][:, s:s + chunk]
            for m in mats[1:-1]:
                blk = m[:, s:s + chunk]
                kr = (kr[:, :, :, None] * blk[:, :, None, :]).reshape(
                    b, kr.shape[1], -1)
            out = out + kr.transpose(1, 2) @ mats[-1][:, s:s + chunk]
    return (out.reshape(-1) if batch is None else out.reshape(b, -1)), mvars


# --------------------------------------------------------------------------
# compatibility wrapper: compile + execute on the dense backend
# --------------------------------------------------------------------------

def positive_ct(db: RelationalDB, point: LatticePoint,
                keep: Optional[Sequence[CtVar]] = None,
                dtype=torch.float32,
                stats: Optional[CostStats] = None,
                device=None) -> CtTable:
    """Positive ct-table ``ct_+`` of a lattice point: counts over value
    combinations of ``keep`` among groundings where every relationship of
    the point holds.  ``keep`` may contain entity-attr and edge-attr CtVars
    of the point; defaults to all of them.  Indicator axes are *not*
    present (they are all implicitly T) — the Möbius join adds them.

    Equivalent to compiling a plan and running the dense executor on
    ``device`` (``None`` = the CUDA card)."""
    from .executors import DenseExecutor     # local import: avoids a cycle
    from .plan import compile_plan
    plan = compile_plan(db.schema, point, keep)
    return DenseExecutor(dtype=dtype, device=device).positive(db, plan, stats)
