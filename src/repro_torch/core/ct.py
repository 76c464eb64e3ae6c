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
from typing import Sequence, Tuple

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
