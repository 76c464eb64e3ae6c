"""Contingency tables (ct-tables).

The paper stores ct-tables as sparse SQL rows; here they are dense count
tensors over the attribute value space, one axis per :class:`CtVar`, on the
counting device.  Dense tensors keep projection (the PRECOUNT/HYBRID
family-extraction primitive) a pure ``sum`` over axes and keep the Möbius
transform a strided butterfly.  (Sparsity is exploited upstream: the
sparse *executor* contracts raw edge lists in O(nnz) and only the final
table is dense — see :mod:`repro_torch.core.executors`.)  Tables are the
unit of account in the byte-budgeted :class:`~repro_torch.core.cache.CtCache`.

``nnz_rows`` reports the sparse-equivalent row count so benchmarks can be
compared against the paper's Table 5 numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .variables import CtVar


@dataclass
class CtTable:
    vars: Tuple[CtVar, ...]
    counts: torch.Tensor              # shape == tuple(v.card for v in vars)

    def __post_init__(self) -> None:
        expect = tuple(v.card for v in self.vars)
        if tuple(self.counts.shape) != expect:
            raise ValueError(f"ct shape {tuple(self.counts.shape)} != vars "
                             f"{expect}")

    # -- bookkeeping --------------------------------------------------------
    @property
    def size(self) -> int:
        """Dense cell count (memory proxy)."""
        return int(np.prod([v.card for v in self.vars], dtype=np.int64)) if self.vars else 1

    @property
    def nbytes(self) -> int:
        return self.counts.numel() * self.counts.element_size()

    def nnz_rows(self) -> int:
        """Sparse-equivalent number of ct-table rows (paper Table 5)."""
        return int(torch.count_nonzero(self.counts))

    def total(self) -> float:
        return float(torch.sum(self.counts))

    # -- algebra ------------------------------------------------------------
    def project(self, keep: Sequence[CtVar]) -> "CtTable":
        """Marginalise onto ``keep`` (paper: *projection*), preserving the
        order given in ``keep``."""
        keep = tuple(keep)
        missing = [v for v in keep if v not in self.vars]
        if missing:
            raise KeyError(f"project: vars not in table: {missing}")
        drop = tuple(i for i, v in enumerate(self.vars) if v not in keep)
        counts = torch.sum(self.counts, dim=drop) if drop else self.counts
        cur = tuple(v for v in self.vars if v in keep)
        # permute to requested order
        perm = tuple(cur.index(v) for v in keep)
        if perm != tuple(range(len(perm))):
            counts = counts.permute(perm)
        return CtTable(keep, counts)

    def transpose_to(self, order: Sequence[CtVar]) -> "CtTable":
        order = tuple(order)
        if set(order) != set(self.vars):
            raise ValueError("transpose_to needs the same var set")
        perm = tuple(self.vars.index(v) for v in order)
        return CtTable(order, self.counts.permute(perm))

    def outer(self, other: "CtTable") -> "CtTable":
        """Tensor (Cartesian) product — used to extend a component ct over
        unconstrained variables."""
        a = self.counts.reshape(tuple(self.counts.shape)
                                + (1,) * other.counts.dim())
        return CtTable(self.vars + other.vars, a * other.counts)

    def scale(self, c) -> "CtTable":
        return CtTable(self.vars, self.counts * c)

    def __sub__(self, other: "CtTable") -> "CtTable":
        other = other.transpose_to(self.vars)
        return CtTable(self.vars, self.counts - other.counts)

    def __add__(self, other: "CtTable") -> "CtTable":
        other = other.transpose_to(self.vars)
        return CtTable(self.vars, self.counts + other.counts)


def scalar_table(value: float, dtype=torch.float32, device=None) -> CtTable:
    return CtTable((), torch.tensor(value, dtype=dtype, device=device))


def sum_partials(per_query: Sequence[Sequence[CtTable]]
                 ) -> Tuple[List[CtTable], int]:
    """The exact sum of each query's partial tables (one per shard, same
    vars and shape), batched by shape: the partials of every query in one
    ``(n_partials, shape)`` group are stacked on their device and summed
    over the partial axis in ONE ``torch.sum``.  Counts are integers, so
    any summation order gives the same float32 bits below 2^24.

    Args:
        per_query: one list of aligned partial tables per query.

    Returns:
        ``(merged, dispatches)``: one merged table per query in input
        order (a query of one partial is that table itself), and the number
        of stacked sums issued.

    Usage::

        merged, n = sum_partials([[tab_shard0, tab_shard1]])
    """
    merged: List[Optional[CtTable]] = [None] * len(per_query)
    groups: Dict[Tuple, List[int]] = {}
    for i, tabs in enumerate(per_query):
        if len(tabs) == 1:
            merged[i] = tabs[0]
            continue
        groups.setdefault((len(tabs), tuple(tabs[0].counts.shape)),
                          []).append(i)
    for (n_partials, _), idxs in groups.items():
        stacked = torch.stack([torch.stack([per_query[i][s].counts
                                            for i in idxs])
                               for s in range(n_partials)])
        rows = list(torch.sum(stacked, dim=0).unbind(0))
        if len(rows) > 1:     # each merged table owns its storage, so that
            rows = [r.clone() for r in rows]   # a cached one pins no group
        for row, i in zip(rows, idxs):
            merged[i] = CtTable(per_query[i][0].vars, row)
    return merged, len(groups)                             # type: ignore
