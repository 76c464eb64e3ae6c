"""BDeu scoring of families from contingency tables (paper Eq. 1).

The ct-table for (parents, child) is reshaped to ``N_ijk`` with ``j`` ranging
over parent configurations and ``k`` over child values; the score is the usual
Dirichlet-multinomial marginal likelihood with equivalent sample size ``N'``.
The lgamma-heavy reduction is the scoring hot spot: on the card it runs in
the batched CUDA kernel ``kernels/csrc/bdeu.cu`` (K4), on the host in its
plain version.
"""

from __future__ import annotations

import torch

from ..kernels import ops
from .ct import CtTable
from .variables import CtVar


def bdeu_score_2d(nijk: torch.Tensor, ess: float = 1.0) -> torch.Tensor:
    """BDeu log marginal likelihood for N_ijk of shape (q, r) (a 0-d
    tensor)."""
    return bdeu_score_batch(nijk[None], ess)[0]


def bdeu_score_batch(nijk: torch.Tensor, ess: float = 1.0) -> torch.Tensor:
    """Batched BDeu: ``(B, q, r) -> (B,)`` in one call.

    Structure search groups same-shape families per hill-climbing round and
    scores each group here — one launch for the whole candidate set."""
    return ops.bdeu(nijk.to(torch.float32).contiguous(), ess)


def family_nijk(tab: CtTable, child: CtVar) -> torch.Tensor:
    """Reshape a family's complete ct-table to ``N_ijk`` of shape (q, r):
    parent configurations × child values, child axis last."""
    order = tuple(v for v in tab.vars if v != child) + (child,)
    t = tab.transpose_to(order)
    return t.counts.reshape((-1, child.card))


def family_score(tab: CtTable, child: CtVar, ess: float = 1.0,
                 score_fn=None) -> float:
    """Score a family from its complete ct-table.  ``tab`` must contain the
    child axis and any number of parent axes."""
    nijk = family_nijk(tab, child)
    fn = score_fn or bdeu_score_2d
    return float(fn(nijk, ess=ess))
