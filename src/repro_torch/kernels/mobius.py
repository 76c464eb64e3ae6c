"""Superset Möbius transform (K3): the Möbius join's negative phase.

``mobius(x)`` takes a batch of stacks ``[B, 2^k, D]`` and, along the
``2^k`` axis viewed as ``(2,)*k``, applies ``x0 <- x0 - x1`` per axis,
axis 0 (the highest bit) first — the order of
:func:`repro_torch.core.mobius.superset_mobius`, so every element sees the
same float32 subtractions in the same order.  The CUDA kernel is
``csrc/mobius.cu``; the plain version below is the same passes over
strided views.
"""

from __future__ import annotations

import torch

from . import build


def mobius_plain(x: torch.Tensor) -> torch.Tensor:
    b, r, d = x.shape
    k = r.bit_length() - 1
    if 1 << k != r:
        raise ValueError(f"stack height {r} is not a power of two")
    y = x.reshape((b,) + (2,) * k + (d,))
    for i in range(k):
        x1 = y.select(i + 1, 1)
        x0 = y.select(i + 1, 0) - x1
        y = torch.stack([x0, x1], dim=i + 1)
    return y.reshape(b, r, d)


def mobius_matrix(k: int) -> torch.Tensor:
    """Dense transform matrix ``T[A, S] = (-1)^{|S - A|}`` for ``S ⊇ A``
    (bitmask order): ``T @ X`` is the same transform as one matrix
    product."""
    r = 1 << k
    idx = torch.arange(r)
    sub = (idx[:, None] & idx[None, :]) == idx[:, None]
    diff = idx[None, :] & ~idx[:, None]
    bits = torch.zeros_like(diff)
    for i in range(k):
        bits += (diff >> i) & 1
    sign = 1.0 - 2.0 * (bits % 2).float()
    return torch.where(sub, sign, torch.zeros(()))


def max_bits() -> int:
    """Largest ``k`` the CUDA kernel takes."""
    return int(build.load().mobius_max_bits())


def mobius_cuda(x: torch.Tensor) -> torch.Tensor:
    b, r, d = x.shape
    k = r.bit_length() - 1
    if 1 << k != r:
        raise ValueError(f"stack height {r} is not a power of two")
    if k > max_bits():
        raise ValueError(f"mobius kernel takes k <= {max_bits()}, got {k}")
    out = torch.empty_like(x)
    rc = build.load().mobius_batch(
        x.data_ptr(), out.data_ptr(), b, k, d,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mobius launch failed (cudaError {rc})")
    return out
