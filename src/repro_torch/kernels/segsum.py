"""Segment sums (K1, K2): the sparse executor's scatter-add hop.

    out[p]    = sum_{e: seg[e] == p} w[e]          segsum_ones  (K1)
    out[p, d] = sum_{e: seg[e] == p} rows[e, d]    segsum_rows  (K2)

Ids outside ``[0, P)`` are dropped, as ``jax.ops.segment_sum`` drops them
in the reference package (the executors pad with ``seg == P``).  The CUDA
kernels are ``csrc/segsum.cu``; the plain versions below compute the same
function with ``index_add_``, which raises on an out-of-range index, so
they mask first.  :mod:`repro_torch.kernels.ops` routes between the two.
Both segment sums of rows add into ``out`` (a zeroed table unless the
caller passes one to accumulate into).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build


def segsum_ones_plain(seg: torch.Tensor, w: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    keep = (seg >= 0) & (seg < num_segments)
    out = torch.zeros(num_segments, dtype=torch.float32, device=seg.device)
    return out.index_add_(0, seg[keep].long(), w[keep].float())


def segsum_rows_plain(seg: torch.Tensor, rows: torch.Tensor,
                      num_segments: int,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    keep = (seg >= 0) & (seg < num_segments)
    if out is None:
        out = torch.zeros((num_segments, rows.shape[1]), dtype=torch.float32,
                          device=rows.device)
    return out.index_add_(0, seg[keep].long(), rows[keep].float())


def segsum_ones_cuda(seg: torch.Tensor, w: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    out = torch.zeros(num_segments, dtype=torch.float32, device=seg.device)
    rc = build.load().segsum_ones(
        seg.data_ptr(), w.data_ptr(), out.data_ptr(), seg.shape[0],
        num_segments, torch.cuda.current_stream(seg.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segsum_ones launch failed (cudaError {rc})")
    return out


def segsum_rows_cuda(seg: torch.Tensor, rows: torch.Tensor,
                     num_segments: int, out: torch.Tensor) -> torch.Tensor:
    n_edges, width = rows.shape
    rc = build.load().segsum_rows(
        seg.data_ptr(), rows.data_ptr(), out.data_ptr(), n_edges, width,
        num_segments, torch.cuda.current_stream(rows.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segsum_rows launch failed (cudaError {rc})")
    return out
