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
edge row is added into ``out`` where it lands).  K1 has the same two
regimes, chosen by :func:`ones_plan`; it fills an ``out`` it allocates
uninitialised, and its direct regime zeroes and scatters a table larger
than L2 keeps slice by slice in one cooperative launch.

The sparse executor's segment ids come from a third kernel of the same
source, :func:`hop_ids_cuda` (its plain version :func:`hop_ids_plain`):
for each plan ``p`` of a group and each of its edges ``e``, with ``g =
gather[e]``,

    seg[off_p + e]  = p * step + scatter[e] * mult + code(e)
    gidx[off_p + e] = p * gather_step + g

where ``code(e)`` folds the plan's columns in order, ``code * card +
col[g]`` for a column read at the gathered entity and ``code * card +
col[e]`` for one read at the edge.  A plan without a gather or scatter
takes ``g = e`` and no scatter term: the entity codes of a root.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
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


class OnesPlan(NamedTuple):
    """How K1 runs: ``regime`` "private" or "direct" on ``blocks``
    blocks; ``slices`` 0 zeroes ``out`` in a zero kernel launched first,
    ``slices`` >= 1 (direct only) in one cooperative launch that zeroes
    and scatters slice by slice."""
    regime: str
    blocks: int
    slices: int


ONES_SEGMENT_BYTES = 4 * ROWS_THREADS   # K1's tables: a float per thread
ONES_EDGES_PER_THREAD = 4               # one 16-byte load of ids, of weights
ONES_BLOCKS_PER_SM = 8                  # 256-thread blocks an SM holds
ONES_SLICE_BYTES = 12 << 20             # a slice of the table that L2 keeps
ONES_SLICE_EDGES = 50_000               # edges a slice pays its barrier with
ONES_FLUSH_WEIGHT = 6                   # a flush atomic against an edge


def ones_privatisation_limit(card: Card = H100) -> int:
    """The most segments K1 privatises on ``card``: ``ONES_SEGMENT_BYTES``
    each, within ``TABLE_BYTES`` and what a block can opt into."""
    return min(TABLE_BYTES, card.smem_block) // ONES_SEGMENT_BYTES


def ones_plan(n_edges: int, num_segments: int,
              card: Card = H100) -> OnesPlan:
    """K1's regime and launch shape for ``E`` edges into ``P`` segments.
    Privatised when ``P`` is at most :func:`ones_privatisation_limit` and
    there are at least ``MIN_EDGES_PER_SEGMENT`` edges a segment for a
    block, on ``sqrt(E / (ONES_FLUSH_WEIGHT P))`` blocks: more blocks
    give each thread fewer edges but land more flush atomics on the same
    ``P`` addresses, and that balances them (fitted at the IMDb
    histograms); within up to ``ONES_BLOCKS_PER_SM`` blocks an SM (fewer
    where the tables fill its shared memory), no more than
    ``ONES_EDGES_PER_THREAD`` edges a thread needs and at most a quarter
    of the edges' additions in flushes.  Otherwise direct: a
    table of more than ``ONES_SLICE_BYTES`` with at least
    ``ONES_SLICE_EDGES`` edges a slice is zeroed and scattered in slices of
    at most ``ONES_SLICE_BYTES`` by one cooperative launch of a 1,024-thread
    block an SM (each slice's grid barrier costs about what that many
    edges gain from finding the table in L2);
    any other is zeroed first, then scattered on as many blocks as give
    each thread ``ONES_EDGES_PER_THREAD`` edges, up to
    ``ONES_BLOCKS_PER_SM`` an SM."""
    p = max(num_segments, 1)
    wanted = -(-n_edges // (ONES_EDGES_PER_THREAD * ROWS_THREADS))
    most_splits = n_edges // (MIN_EDGES_PER_SEGMENT * p)
    if p <= ones_privatisation_limit(card) and most_splits >= 1:
        smem = p * ONES_SEGMENT_BYTES + RESERVED_BYTES
        per_sm = max(1, min(ONES_BLOCKS_PER_SM, card.smem_sm // smem))
        balance = math.isqrt(n_edges // (ONES_FLUSH_WEIGHT * p))
        blocks = min(per_sm * card.sms, wanted, most_splits, balance)
        return OnesPlan("private", max(1, blocks), 0)
    slices = -(-4 * p // ONES_SLICE_BYTES)
    if slices > 1 and n_edges >= slices * ONES_SLICE_EDGES:
        return OnesPlan("direct", card.sms, slices)
    blocks = min(ONES_BLOCKS_PER_SM * card.sms, wanted)
    return OnesPlan("direct", max(1, blocks), 0)


def segsum_ones_cuda(seg: torch.Tensor, w: torch.Tensor, num_segments: int,
                     plan: OnesPlan) -> torch.Tensor:
    out = torch.empty(num_segments, dtype=torch.float32, device=seg.device)
    rc = build.load().segsum_ones(
        seg.data_ptr(), w.data_ptr(), out.data_ptr(), seg.shape[0],
        num_segments, REGIMES.index(plan.regime), plan.blocks, plan.slices,
        torch.cuda.current_stream(seg.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segsum_ones launch failed (cudaError {rc}, "
                           f"{plan})")
    return out


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


class IdPart(NamedTuple):
    """One plan's inputs to the id kernel: ``n`` edges (or entities), the
    int32 ``gather`` and ``scatter`` index columns of length ``n`` (each
    ``None`` where the plan has none) and its int32 code ``cols``."""
    n: int
    gather: Optional[torch.Tensor]
    scatter: Optional[torch.Tensor]
    cols: Tuple[torch.Tensor, ...]


IDS_MAX_COLS = 32                 # csrc/segsum.cu's kIdsMaxCols


def hop_ids_plain(parts: Sequence[IdPart], cards: Sequence[int],
                  gathered: Sequence[bool], step: int, mult: int,
                  gather_step: Optional[int], device: torch.device
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    n_all = sum(p.n for p in parts)
    seg = torch.empty(n_all, dtype=torch.int32, device=device)
    gidx = None if gather_step is None else torch.empty_like(seg)
    off = 0
    for i, p in enumerate(parts):
        g = None if p.gather is None else p.gather.long()
        code = torch.zeros(p.n, dtype=torch.int64, device=device)
        for col, card, at_gather in zip(p.cols, cards, gathered):
            code = code * card + (col[g] if at_gather and g is not None
                                  else col).long()
        if p.scatter is not None:
            code += p.scatter.long() * mult
        seg[off:off + p.n] = code + i * step
        if gidx is not None:
            gidx[off:off + p.n] = g + i * gather_step
        off += p.n
    return seg, gidx


def hop_ids_table(parts: Sequence[IdPart], cards: Sequence[int],
                  gathered: Sequence[bool]) -> np.ndarray:
    """The id kernel's int64 argument table: the columns' cards and
    gathered flags, then per plan its offset, edge count and the device
    addresses of its gather, scatter and columns (0 for none)."""
    k = len(cards)
    rows = np.zeros((len(parts), 4 + k), dtype=np.int64)
    off = 0
    for row, p in zip(rows, parts):
        row[0], row[1] = off, p.n
        row[2] = 0 if p.gather is None else p.gather.data_ptr()
        row[3] = 0 if p.scatter is None else p.scatter.data_ptr()
        row[4:] = [c.data_ptr() for c in p.cols]
        off += p.n
    return np.concatenate([np.asarray(cards, dtype=np.int64),
                           np.asarray(gathered, dtype=np.int64),
                           rows.reshape(-1)])


def hop_ids_table_bytes(n_plans: int, n_cols: int) -> int:
    """The bytes of :func:`hop_ids_table`'s table."""
    return 8 * (2 * n_cols + n_plans * (4 + n_cols))


def to_card(table: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array on ``device`` through pinned memory, without
    waiting for the card (the pinned block is not reused until the copy
    is done)."""
    return torch.from_numpy(table).pin_memory().to(device, non_blocking=True)


def hop_ids_cuda(table: torch.Tensor, n_plans: int, n_cols: int,
                 max_edges: int, step: int, mult: int,
                 gather_step: Optional[int], seg: torch.Tensor,
                 gidx: Optional[torch.Tensor]) -> None:
    rc = build.load().hop_ids(
        table.data_ptr(), n_plans, n_cols, max_edges, step, mult,
        0 if gather_step is None else gather_step, seg.data_ptr(),
        None if gidx is None else gidx.data_ptr(),
        torch.cuda.current_stream(seg.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hop_ids launch failed (cudaError {rc}, "
                           f"{n_plans} plans, {n_cols} columns)")
