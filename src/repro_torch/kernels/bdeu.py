"""Batched BDeu family score (K4).

``bdeu(nijk, ess)`` maps ``N_ijk [B, q, r]`` to one log marginal
likelihood per family, ``[B]``:

    sum_j [ lgamma(a_j) - lgamma(N_ij + a_j)
            + sum_k (lgamma(N_ijk + a_jk) - lgamma(a_jk)) ]

with ``a_j = ess / q`` and ``a_jk = ess / (q r)``.

Structure search compares score *differences*, and BDeu is score
equivalent: reversing an edge between two parentless nodes changes the
score by exactly the same amount either way.  Whether such a tie breaks
the same way on the card and on the host depends on the last bit of every
term, so the score here is bit-reproducible by construction:

* ``lgamma`` is :func:`lgamma_f32`, a Lanczos approximation over a
  ``frexp``-based logarithm written with correctly rounded float32
  ``+ - * /`` only — no library ``lgamma``/``log``, whose last bits differ
  between the CPU and CUDA math libraries;
* ``sum_k`` runs left to right; ``sum_j`` runs as the kernel's block
  does: lane ``t`` of ``LANES`` adds rows ``t, t + LANES, ...`` in turn,
  then the lanes meet in a pairwise tree.

The CUDA kernel ``csrc/bdeu.cu`` performs exactly these operations in the
same order (``__fadd_rn``-style intrinsics, no contraction into FMA), so it
equals the plain version below bit for bit.  It evaluates the lgammas of a
chunk of rows all at once (their order does not matter) and leaves out the
additions of the padding's ``+0.0``, which change no bit because a lane
never holds ``-0.0`` (``_bdeu_rows`` over fewer lanes shows the same).
"""

from __future__ import annotations

import torch

from . import build

# float32 constants, written as the exact values the CUDA source uses
_SQRT_HALF = 0.7071067690849304
_C3, _C5 = 0.3333333432674408, 0.20000000298023224
_C7, _C9 = 0.1428571492433548, 0.1111111119389534
_LN2_HI, _LN2_LO = 0.693359375, -0.00021219444170128554
_HALF_LOG_2PI = 0.9189385175704956
_LANCZOS = (1.0, 676.5203857421875, -1259.13916015625, 771.3234252929688,
            -176.6150360107422, 12.507343292236328, -0.138571098446846,
            9.984369171434082e-06, 1.5056326674312004e-07)
LANES = 256                       # lanes of csrc/bdeu.cu's sum
MAX_R = 200 * 1024 // 4 - 1       # csrc/bdeu.cu's kMaxChunkBytes: r + 1
                                  # lgammas of one row


def _const(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full_like(like, value)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive float32 ``x`` from correctly rounded
    operations: ``x = m 2^e`` with ``m`` in ``[sqrt(1/2), sqrt(2))``, then
    ``log(m) = 2 atanh(f / (f + 2))`` with ``f = m - 1`` (exact)."""
    m, e = torch.frexp(x)
    small = m < _SQRT_HALF
    m = torch.where(small, m + m, m)
    e = torch.where(small, e - 1, e)
    f = m - 1.0
    s = f / (f + 2.0)
    s2 = s * s
    p = s2 * _C9 + _C7
    p = p * s2 + _C5
    p = p * s2 + _C3
    p = p * s2
    s_2 = s + s
    r = s_2 + s_2 * p
    ef = e.to(torch.float32)
    return ef * _LN2_HI + (ef * _LN2_LO + r)


def lgamma_f32(x: torch.Tensor) -> torch.Tensor:
    """``lgamma`` of positive float32 ``x`` (Lanczos, g = 7, 9 terms; for
    ``x < 1/2`` through ``lgamma(x) = lgamma(x + 1) - log(x)``)."""
    small = x < 0.5
    xx = torch.where(small, x + 1.0, x)
    z = xx - 1.0
    a = _const(z, _LANCZOS[0])
    for i in range(1, len(_LANCZOS)):
        a = a + _const(z, _LANCZOS[i]) / (z + float(i))
    t = z + 7.5
    v = ((_HALF_LOG_2PI + (z + 0.5) * log_f32(t)) - t) + log_f32(a)
    return torch.where(small, v - log_f32(torch.where(small, x, 1.0)), v)


def _bdeu_rows(nijk: torch.Tensor, a_j: float, a_jk: float,
               lanes: int = LANES) -> torch.Tensor:
    """Per-family score of ``[B, q, r]`` for the given Dirichlet
    parameters (rounded to float32, as the kernel receives them), summed
    over ``lanes`` lanes (a power of two; the kernel's are ``LANES``)."""
    nijk = nijk.float()
    b, q, r = nijk.shape
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=nijk.device)
    aj, ajk = f32(a_j), f32(a_jk)
    lg_aj, lg_ajk = lgamma_f32(aj), lgamma_f32(ajk)
    cell = lgamma_f32(nijk + ajk) - lg_ajk                   # [B, q, r]
    nij, terms = nijk[..., 0], cell[..., 0]
    for k in range(1, r):
        nij = nij + nijk[..., k]
        terms = terms + cell[..., k]
    per_j = (lg_aj - lgamma_f32(nij + aj)) + terms           # [B, q]
    n_blocks = -(-q // lanes)
    per_j = torch.cat([per_j, per_j.new_zeros(b, n_blocks * lanes - q)],
                      dim=1).reshape(b, n_blocks, lanes)
    acc = per_j.new_zeros(b, lanes)
    for i in range(n_blocks):                 # each lane's rows, in turn
        acc = acc + per_j[:, i]
    width = lanes
    while width > 1:                          # the block's pairwise tree
        width //= 2
        acc = acc[:, :width] + acc[:, width:]
    return acc[:, 0]


def bdeu_plain(nijk: torch.Tensor, ess: float) -> torch.Tensor:
    _, q, r = nijk.shape
    return _bdeu_rows(nijk, ess / q, ess / (q * r))


def bdeu_cuda(nijk: torch.Tensor, ess: float) -> torch.Tensor:
    b, q, r = nijk.shape
    out = torch.empty(b, dtype=torch.float32, device=nijk.device)
    rc = build.load().bdeu_batch(
        nijk.data_ptr(), out.data_ptr(), b, q, r, ess / q, ess / (q * r),
        torch.cuda.current_stream(nijk.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bdeu launch failed (cudaError {rc})")
    return out


def check_division(device: torch.device) -> list:
    """``csrc/bdeu.cu``'s proof of its lgamma's fast path, run on the card:
    how many operands of the fast path's domain its branch-free division
    (the eight Lanczos terms; log's ``f / (f + 2)``) and its frexp give
    other bits than the correctly rounded operations.  ``[0, 0, 0]`` where
    the fast path equals the plain version's arithmetic."""
    bad = torch.zeros(3, dtype=torch.int64, device=device)
    rc = build.load().bdeu_check_division(
        bad.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bdeu_check_division failed (cudaError {rc})")
    return bad.tolist()
