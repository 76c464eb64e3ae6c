"""The kernels' plain versions under the reference package's names
(``repro.kernels.ref``), each on one unbatched input as there."""

from __future__ import annotations

import torch

from .attention import flash_attention_plain
from .bdeu import _bdeu_rows
from .mobius import mobius_plain
from .segsum import segment_hist_plain, segsum_ones_plain, segsum_rows_plain


def ones_segment_sum_ref(seg: torch.Tensor, weights: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """Weighted histogram: out[p] = sum_{e: seg[e]=p} weights[e]."""
    return segsum_ones_plain(seg, weights, num_segments)


def edge_segment_sum_ref(seg: torch.Tensor, rows: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """Sparse hop scatter-add: out[p, d] = sum_{e: seg[e]=p} rows[e, d];
    out-of-range segment ids are dropped."""
    return segsum_rows_plain(seg, rows, num_segments)


def mobius_ref(stack: torch.Tensor) -> torch.Tensor:
    """Superset Möbius transform on a [R=2^k, D] stack."""
    return mobius_plain(stack[None])[0]


def bdeu_ref(nijk: torch.Tensor, ess: float, q: int, r: int) -> torch.Tensor:
    """BDeu log marginal likelihood over N_ijk [Q, R] with the Dirichlet
    parameters of a (q, r) family."""
    return _bdeu_rows(nijk[None], ess / q, ess / (q * r))[0]


#: Weighted histogram / segment sum: ``out[p, d] = sum_{n: codes[n]=p}
#: values[n, d]``.
segment_hist_ref = segment_hist_plain

#: Attention forward of ``q [B, S, H, hd]`` over ``k, v`` (the kernel's
#: plain version, grouped KV heads included).
flash_attention_ref = flash_attention_plain
