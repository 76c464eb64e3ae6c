"""Routing wrappers for the port's kernels, with launch counters.

Each wrapper takes the plain PyTorch version for a tensor on the CPU and
launches its CUDA kernel for a tensor on the card; there is no other
route and no fallback.  On the card it checks device, dtype, shape and
contiguity and raises on anything the kernel does not take.

``LAUNCHES[name]`` counts kernel launches and ``PLAIN_CALLS[name]`` counts
calls served by the plain version, so a run can show which path it went
through.  A call with no work (no edges, an empty batch) returns its
(zero) result without either.

Unlike the JAX package's predicate (``repro.kernels.ops
.segsum_kernel_enabled``), segment sums are not capped by segment count:
that cap priced a one-hot sweep of O(edges x segments), while the CUDA
kernel is an atomic scatter of O(edges).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .bdeu import bdeu_cuda, bdeu_plain
from .mobius import mobius_cuda, mobius_plain
from .segsum import (segsum_ones_cuda, segsum_ones_plain, segsum_rows_cuda,
                     segsum_rows_plain)

KERNELS = ("segsum_ones", "segsum_rows", "mobius", "bdeu")
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
PLAIN_CALLS: Dict[str, int] = {name: 0 for name in KERNELS}

_INT32_MAX = 2 ** 31 - 1


def reset_counts() -> None:
    """Set every launch and plain-call count to 0."""
    for name in KERNELS:
        LAUNCHES[name] = 0
        PLAIN_CALLS[name] = 0


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """``True`` for CUDA tensors (kernel route), ``False`` for CPU tensors
    (plain route); raises on anything else or on mixed devices."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type == "cpu":
        PLAIN_CALLS[name] += 1
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return True


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def segsum_ones(seg: torch.Tensor, w: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[p] = sum_{e: seg[e]==p} w[e]`` (float32 ``[P]``); ids outside
    ``[0, P)`` are dropped."""
    if not _on_card("segsum_ones", seg, w):
        return segsum_ones_plain(seg, w, num_segments)
    _check("segsum_ones", seg, torch.int32, 1)
    _check("segsum_ones", w, torch.float32, 1)
    if w.shape[0] != seg.shape[0]:
        raise ValueError("segsum_ones: seg and w differ in length")
    if not 0 <= num_segments <= _INT32_MAX:
        raise ValueError("segsum_ones: segment space exceeds int32")
    if seg.shape[0] == 0 or num_segments == 0:
        return torch.zeros(num_segments, dtype=torch.float32,
                           device=seg.device)
    out = segsum_ones_cuda(seg, w, num_segments)
    LAUNCHES["segsum_ones"] += 1
    return out


def segsum_rows(seg: torch.Tensor, rows: torch.Tensor, num_segments: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[p, d] += sum_{e: seg[e]==p} rows[e, d]`` (float32 ``[P, D]``,
    a new zeroed table unless ``out`` is given); ids outside ``[0, P)``
    are dropped."""
    shape = (num_segments, rows.shape[1])
    if out is not None:
        if (out.shape != shape or out.dtype != torch.float32
                or not out.is_contiguous()):
            raise ValueError(f"segsum_rows: out must be a contiguous float32 "
                             f"{shape} table")
        if not _on_card("segsum_rows", seg, rows, out):
            return segsum_rows_plain(seg, rows, num_segments, out)
    elif not _on_card("segsum_rows", seg, rows):
        return segsum_rows_plain(seg, rows, num_segments)
    _check("segsum_rows", seg, torch.int32, 1)
    _check("segsum_rows", rows, torch.float32, 2)
    if rows.shape[0] != seg.shape[0]:
        raise ValueError("segsum_rows: seg and rows differ in length")
    if not 0 <= num_segments <= _INT32_MAX:
        raise ValueError("segsum_rows: segment space exceeds int32")
    if out is None:
        out = torch.zeros(shape, dtype=torch.float32, device=rows.device)
    if rows.numel() == 0 or num_segments == 0:
        return out
    segsum_rows_cuda(seg, rows, num_segments, out)
    LAUNCHES["segsum_rows"] += 1
    return out


def mobius(x: torch.Tensor) -> torch.Tensor:
    """Superset Möbius transform of a batch of stacks ``[B, 2^k, D]``
    (float32), highest bit first."""
    if not _on_card("mobius", x):
        return mobius_plain(x)
    _check("mobius", x, torch.float32, 3)
    if x.numel() == 0:
        return x.clone()
    out = mobius_cuda(x)
    LAUNCHES["mobius"] += 1
    return out


def bdeu(nijk: torch.Tensor, ess: float = 1.0) -> torch.Tensor:
    """BDeu score per family of ``N_ijk [B, q, r]`` (float32) -> ``[B]``."""
    if not _on_card("bdeu", nijk):
        return bdeu_plain(nijk, ess)
    _check("bdeu", nijk, torch.float32, 3)
    if nijk.shape[0] == 0:
        return torch.zeros(0, dtype=torch.float32, device=nijk.device)
    out = bdeu_cuda(nijk, ess)
    LAUNCHES["bdeu"] += 1
    return out
