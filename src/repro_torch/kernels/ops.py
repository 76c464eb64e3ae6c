"""Routing wrappers for the port's kernels, with launch counters.

Each wrapper takes the plain PyTorch version for a tensor on the CPU and
launches its CUDA kernel for a tensor on the card; there is no other
route and no fallback.  On the card it checks device, dtype, shape and
contiguity and raises on anything the kernel does not take.

``LAUNCHES[name]`` counts kernel launches and ``PLAIN_CALLS[name]`` counts
calls served by the plain version, so a run can show which path it went
through; ``BACKWARD_CALLS["flash_attention"]`` counts attention backwards
(plain PyTorch on either device: there is no backward kernel).  A call with no work (no edges, an empty batch) returns its
(zero) result without either.  The counting service's dispatcher and every
searcher thread call the wrappers at once, so each count moves under one
lock (:func:`_bump`).

Unlike the JAX package's predicate (``repro.kernels.ops
.segsum_kernel_enabled``), segment sums are not capped by segment count:
that cap priced a one-hot sweep of O(edges x segments), while the CUDA
kernel is an atomic scatter of O(edges).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

from .attention import (flash_attention_backward, flash_attention_cuda,
                        flash_attention_plain)
from .bdeu import MAX_R, bdeu_cuda, bdeu_plain
from .mobius import mobius_cuda, mobius_plain
from .segsum import (IDS_MAX_COLS, REGIMES, IdPart, card_of, hop_ids_cuda,
                     hop_ids_plain, hop_ids_table, ones_plan, rows_plan,
                     segment_hist_plain, segsum_ones_cuda, segsum_ones_plain,
                     segsum_rows_cuda, segsum_rows_plain, to_card)

KERNELS = ("segsum_ones", "segsum_rows", "mobius", "bdeu", "segment_hist",
           "flash_attention", "hop_ids")
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
PLAIN_CALLS: Dict[str, int] = {name: 0 for name in KERNELS}
#: Launches of the row scatter (K2 and K5 together) by regime.
ROW_REGIMES: Dict[str, int] = {regime: 0 for regime in REGIMES}
#: Launches of K1 by regime.
ONES_REGIMES: Dict[str, int] = {regime: 0 for regime in REGIMES}
#: Attention backwards (:class:`FlashAttention`).
BACKWARD_CALLS: Dict[str, int] = {"flash_attention": 0}

_COUNT_LOCK = threading.Lock()

_INT32_MAX = 2 ** 31 - 1
_GRID_MAX = 65535                  # CUDA's limit on gridDim.y and .z
_ROW_WIDTH_MAX = 2 ** 30           # the row scatter's int32 column offsets


def reset_counts() -> None:
    """Set every launch and plain-call count to 0."""
    with _COUNT_LOCK:
        for name in KERNELS:
            LAUNCHES[name] = 0
            PLAIN_CALLS[name] = 0
        for regime in REGIMES:
            ROW_REGIMES[regime] = 0
            ONES_REGIMES[regime] = 0
        BACKWARD_CALLS["flash_attention"] = 0


def _bump(counts: Dict[str, int], key: str,
          regimes: Optional[Dict[str, int]] = None,
          regime: Optional[str] = None) -> None:
    """Add one to ``counts[key]`` (and to ``regimes[regime]``) under the
    counters' lock: a bare ``+=`` on a shared dict loses increments when
    threads switch between its read and its write."""
    with _COUNT_LOCK:
        counts[key] += 1
        if regimes is not None:
            regimes[regime] += 1


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """``True`` for CUDA tensors (kernel route), ``False`` for CPU tensors
    (plain route); raises on anything else or on mixed devices."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    return _device_on_card(name, dev)


def _device_on_card(name: str, dev: torch.device) -> bool:
    """:func:`_on_card` for work on ``dev``."""
    if dev.type == "cpu":
        _bump(PLAIN_CALLS, name)
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


def _check_rows(name: str, seg: torch.Tensor, rows: torch.Tensor,
                num_segments: int) -> None:
    """The row scatter's inputs: int32 ids ``[E]``, float32 rows ``[E, D]``
    and an int32 segment space."""
    _check(name, seg, torch.int32, 1)
    _check(name, rows, torch.float32, 2)
    if rows.shape[0] != seg.shape[0]:
        raise ValueError(f"{name}: ids and rows differ in length")
    if rows.shape[1] > _ROW_WIDTH_MAX:
        raise ValueError(f"{name}: rows wider than {_ROW_WIDTH_MAX}")
    if not 0 <= num_segments <= _INT32_MAX:
        raise ValueError(f"{name}: segment space exceeds int32")


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
    plan = ones_plan(seg.shape[0], num_segments, card_of(seg.device))
    out = segsum_ones_cuda(seg, w, num_segments, plan)
    _bump(LAUNCHES, "segsum_ones", ONES_REGIMES, plan.regime)
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
    _check_rows("segsum_rows", seg, rows, num_segments)
    if out is None:
        out = torch.zeros(shape, dtype=torch.float32, device=rows.device)
    if rows.numel() == 0 or num_segments == 0:
        return out
    _row_scatter(seg, rows, num_segments, out, "segsum_rows")
    return out


def _row_scatter(seg: torch.Tensor, rows: torch.Tensor, num_segments: int,
                 out: torch.Tensor, name: str) -> None:
    """K2's kernel in the regime :func:`.segsum.rows_plan` picks, counted
    as a launch of ``name``."""
    plan = rows_plan(rows.shape[0], rows.shape[1], num_segments,
                     card_of(rows.device))
    segsum_rows_cuda(seg, rows, num_segments, out, plan)
    _bump(LAUNCHES, name, ROW_REGIMES, plan.regime)


def hop_ids(parts: Sequence[IdPart], cards: Sequence[int],
            gathered: Sequence[bool], step: int, mult: int = 0,
            gather_step: Optional[int] = None, *, device: torch.device
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A group's int32 segment ids, plan ``i``'s edges ``e`` at
    ``i * step + scatter[e] * mult + code(e)``, laid end to end, and with
    ``gather_step`` the int32 gather indices ``i * gather_step +
    gather[e]`` (see :mod:`.segsum`).  ``code(e)`` folds the plan's
    ``cols`` by ``cards``, each read at ``gather[e]`` where its
    ``gathered`` flag is set and at ``e`` otherwise.  Every tensor is on
    ``device``; on the card the argument table goes there through pinned
    memory (:func:`.segsum.to_card`).  Every id must lie below
    ``len(parts) * step``, and so fit int32."""
    parts, device = list(parts), torch.device(device)
    tensors = [t for p in parts for t in (p.gather, p.scatter, *p.cols)
               if t is not None]
    if any(t.device != device for t in tensors):
        raise ValueError(f"hop_ids: tensors off {device}")
    on_card = _device_on_card("hop_ids", device)
    if len(cards) != len(gathered) or any(len(p.cols) != len(cards)
                                          for p in parts):
        raise ValueError("hop_ids: every plan needs one column a card")
    if gather_step is not None and any(p.gather is None for p in parts):
        raise ValueError("hop_ids: gather indices need every plan's gather")
    if len(parts) * max(step, gather_step or 0) > _INT32_MAX + 1:
        raise ValueError("hop_ids: ids exceed int32")
    if not on_card:
        return hop_ids_plain(parts, cards, gathered, step, mult, gather_step,
                             device)
    for t in tensors:
        _check("hop_ids", t, torch.int32, 1)
    if len(cards) > IDS_MAX_COLS:
        raise ValueError(f"hop_ids: more than {IDS_MAX_COLS} columns")
    for p in parts:
        for t in (p.gather, p.scatter):
            if t is not None and t.shape[0] != p.n:
                raise ValueError("hop_ids: an index column is not n long")
        for c, at_gather in zip(p.cols, gathered):
            if not at_gather and c.shape[0] != p.n:
                raise ValueError("hop_ids: an edge column is not n long")
    n_all = sum(p.n for p in parts)
    seg = torch.empty(n_all, dtype=torch.int32, device=device)
    gidx = None if gather_step is None else torch.empty_like(seg)
    if n_all == 0:
        return seg, gidx
    table = to_card(hop_ids_table(parts, cards, gathered), device)
    hop_ids_cuda(table, len(parts), len(cards), max(p.n for p in parts),
                 step, mult, gather_step, seg, gidx)
    _bump(LAUNCHES, "hop_ids")
    return seg, gidx


def mobius(x: torch.Tensor) -> torch.Tensor:
    """Superset Möbius transform of a batch of stacks ``[B, 2^k, D]``
    (float32), highest bit first."""
    if not _on_card("mobius", x):
        return mobius_plain(x)
    _check("mobius", x, torch.float32, 3)
    if x.numel() == 0:
        return x.clone()
    out = mobius_cuda(x)
    _bump(LAUNCHES, "mobius")
    return out


def bdeu(nijk: torch.Tensor, ess: float = 1.0) -> torch.Tensor:
    """BDeu score per family of ``N_ijk [B, q, r]`` (float32) -> ``[B]``."""
    if not _on_card("bdeu", nijk):
        return bdeu_plain(nijk, ess)
    _check("bdeu", nijk, torch.float32, 3)
    if nijk.shape[0] == 0:
        return torch.zeros(0, dtype=torch.float32, device=nijk.device)
    if not 1 <= nijk.shape[2] <= MAX_R or nijk.shape[1] < 1:
        raise ValueError(f"bdeu: the kernel takes q >= 1 and 1 <= r <= "
                         f"{MAX_R}, got {tuple(nijk.shape)}")
    out = bdeu_cuda(nijk, ess)
    _bump(LAUNCHES, "bdeu")
    return out


def segment_hist(codes: torch.Tensor, values: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Weighted segment histogram ``out[p, d] = sum_{n: codes[n]==p}
    values[n, d]`` (float32 ``[P, D]``); codes outside ``[0, P)`` are
    dropped.  On the card it is K2's row scatter into a zeroed table."""
    if not _on_card("segment_hist", codes, values):
        return segment_hist_plain(codes, values, num_segments)
    _check_rows("segment_hist", codes, values, num_segments)
    out = torch.zeros((num_segments, values.shape[1]), dtype=torch.float32,
                      device=values.device)
    if values.numel() == 0 or num_segments == 0:
        return out
    _row_scatter(codes, values, num_segments, out, "segment_hist")
    return out


class FlashAttention(torch.autograd.Function):
    """K6 under autograd: the forward is :func:`_flash_forward` (K6 on the
    card, its plain version on the host) and saves ``q, k, v``; the
    backward recomputes the scores chunk by chunk in float32
    (:func:`.attention.flash_attention_backward`), as the JAX package's
    gradient rematerialises each query block of ``block_attention``."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, q_offset: int = 0) -> torch.Tensor:
        ctx.causal, ctx.q_offset = causal, q_offset
        ctx.save_for_backward(q, k, v)
        return _flash_forward(q, k, v, causal, q_offset)

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        q, k, v = ctx.saved_tensors
        _bump(BACKWARD_CALLS, "flash_attention")
        # a named range, so that a profile can add up the backward's kernels
        with torch.profiler.record_function("flash_attention.backward"):
            grads = flash_attention_backward(q, k, v, dout, ctx.causal,
                                             q_offset=ctx.q_offset)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Attention of ``q [B, Sq, H, hd]`` over ``k, v [B, Skv, Hkv, hd]``
    with ``Hkv | H`` (query head ``h`` reads KV head ``h // (H // Hkv)``)
    -> ``[B, Sq, H, hd]`` in ``q``'s dtype; see :mod:`.attention`.  With
    ``causal``, query row ``i`` keeps key ``j <= q_offset + i``.
    Differentiable (:class:`FlashAttention`)."""
    return FlashAttention.apply(q, k, v, causal, int(q_offset))


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, q_offset: int = 0) -> torch.Tensor:
    """The attention forward: K6 for tensors on the card, its plain version
    for tensors on the CPU."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: expected q [B, Sq, H, hd] and "
                         f"k, v [B, Skv, Hkv, hd]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or k.shape[2] < 1 \
            or h % k.shape[2] != 0:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (batch and hd equal, Hkv | H)")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    if not _on_card("flash_attention", q, k, v):
        return flash_attention_plain(q, k, v, causal, q_offset=q_offset)
    for t in (q, k, v):
        if t.dtype != q.dtype or t.dtype not in (torch.float32,
                                                 torch.bfloat16):
            raise TypeError("flash_attention: q, k, v must all be float32 "
                            "or all bfloat16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention: inputs must be contiguous "
                             "and 16-byte aligned")
    if b > _GRID_MAX or h > _GRID_MAX:
        raise ValueError("flash_attention: batch or heads exceed the grid")
    if q.numel() == 0 or k.shape[1] == 0:
        return torch.zeros_like(q)
    out = flash_attention_cuda(q, k, v, causal, q_offset)
    _bump(LAUNCHES, "flash_attention")
    return out
