"""Segment sums (K1, K2): the sparse executor's scatter-add hop, and the
weighted segment histogram (K5), which has K2's contract.

    out[p]    = sum_{e: seg[e] == p} w[e]               segsum_ones   (K1)
    out[p, d] = sum_{e: seg[e] == p} rows[e, d]         segsum_rows   (K2)
    out[p, d] = sum_{n: codes[n] == p} values[n, d]     segment_hist  (K5)

Ids outside ``[0, P)`` are dropped, as ``jax.ops.segment_sum`` drops them
in the reference package (the executors pad with ``seg == P``).  The CUDA
kernels are ``csrc/segsum.cu``; the plain versions below compute the same
function with ``index_add_``, which raises on an out-of-range index, so
they mask first.  :mod:`repro_torch.kernels.ops` routes between the two.
Both segment sums of rows add into ``out`` (a zeroed table unless the
caller passes one to accumulate into).  K5 launches K2's row scatter
into a zeroed table under a launch counter of its own.

The row scatter runs in one of two regimes, chosen here by
:func:`rows_plan` from the shape and the card's shared memory and passed
to the kernel: *privatised* (each block sums a column tile of every
segment in shared memory, then adds it into ``out``) when that table fits
and there are enough edges per segment to pay for it, else *direct* (each
edge row is added into ``out`` where it lands).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

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


class Card(NamedTuple):
    """The limits of a card that the row scatter's regime choice reads."""
    sms: int
    smem_block: int      # bytes of shared memory a block can opt into
    smem_sm: int         # bytes of shared memory of one SM


H100 = Card(sms=132, smem_block=232_448, smem_sm=233_472)

ROWS_THREADS = 256               # csrc/segsum.cu's kThreads
IDS_BYTES = 4 * ROWS_THREADS     # a privatised block's staged ids
TABLE_BYTES = 200 * 1024         # most shared memory privatised tables take
SEGMENT_BYTES = 16 * ROWS_THREADS  # their bytes per segment, whatever T is
RESERVED_BYTES = 1024            # shared memory the card keeps per block
MIN_EDGES_PER_SEGMENT = 4        # a privatised block's edges per segment
PRIVATE_BLOCKS_PER_SM = 4
DIRECT_BLOCKS_PER_SM = 8
REGIMES = ("direct", "private")  # the C entry's regime codes, in order


class RowsPlan(NamedTuple):
    """How the row scatter runs: ``regime`` "private" with ``tile``
    columns per block over ``blocks`` edge splits, or "direct" with
    ``tile`` threads per edge row on ``blocks`` blocks."""
    regime: str
    tile: int
    blocks: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def privatisation_limit(card: Card = H100) -> int:
    """The most segments that privatise on ``card``: ``SEGMENT_BYTES``
    each, within ``TABLE_BYTES`` and what a block can opt into beside its
    staged ids."""
    return min(TABLE_BYTES, card.smem_block - IDS_BYTES) // SEGMENT_BYTES


def rows_plan(n_edges: int, width: int, num_segments: int,
              card: Card = H100) -> RowsPlan:
    """The row scatter's regime and launch shape for ``E`` edge rows of
    ``D`` columns into ``P`` segments.  Privatised when ``P`` is at most
    :func:`privatisation_limit` and there are at least
    ``MIN_EDGES_PER_SEGMENT`` edges per segment, so that the tables'
    flush into ``out`` costs at most a quarter of the rows' additions;
    the tile is the narrowest power of two times 4, up to 1,024 columns,
    that covers ``D``, and the edges split so that up to
    ``PRIVATE_BLOCKS_PER_SM`` blocks run on each SM.  Otherwise direct
    (:func:`direct_plan`)."""
    most_splits = n_edges // (MIN_EDGES_PER_SEGMENT * max(num_segments, 1))
    if num_segments > privatisation_limit(card) or most_splits < 1:
        return direct_plan(n_edges, width, card)
    tile = 4 * min(ROWS_THREADS, _pow2_at_least(-(-width // 4)))
    smem = num_segments * SEGMENT_BYTES + IDS_BYTES + RESERVED_BYTES
    per_sm = max(1, min(PRIVATE_BLOCKS_PER_SM, card.smem_sm // smem))
    splits = -(-per_sm * card.sms // -(-width // tile))
    return RowsPlan("private", tile, max(1, min(splits, most_splits, 65535)))


def direct_plan(n_edges: int, width: int, card: Card = H100) -> RowsPlan:
    """The direct regime's launch shape: a power of two up to a warp of
    threads per row, four columns each, up to ``DIRECT_BLOCKS_PER_SM``
    blocks on each SM."""
    group = min(32, _pow2_at_least(-(-width // 4)))
    blocks = -(-n_edges * group // ROWS_THREADS)
    return RowsPlan("direct", group,
                    max(1, min(blocks, DIRECT_BLOCKS_PER_SM * card.sms)))


_CARDS: Dict[int, Card] = {}


def card_of(device: torch.device) -> Card:
    """``device``'s limits, read once from the CUDA runtime."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _CARDS:
        lib = build.load()
        with torch.cuda.device(index):
            card = Card(*(lib.segsum_card(what) for what in range(3)))
        if min(card) <= 0:
            raise RuntimeError(f"segsum_card could not read device {index}")
        _CARDS[index] = card
    return _CARDS[index]


def segsum_rows_cuda(seg: torch.Tensor, rows: torch.Tensor,
                     num_segments: int, out: torch.Tensor,
                     plan: RowsPlan) -> torch.Tensor:
    n_edges, width = rows.shape
    rc = build.load().segsum_rows(
        seg.data_ptr(), rows.data_ptr(), out.data_ptr(), n_edges, width,
        num_segments, REGIMES.index(plan.regime), plan.tile, plan.blocks,
        torch.cuda.current_stream(rows.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segsum_rows launch failed (cudaError {rc}, "
                           f"{plan})")
    return out


def segment_hist_plain(codes: torch.Tensor, values: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    return segsum_rows_plain(codes, values.float(), num_segments)
