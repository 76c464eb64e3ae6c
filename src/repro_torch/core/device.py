"""Where counting runs: one resolver shared by every entry point.

``device=None`` means the CUDA card.  Without one, the entry points raise
instead of carrying on quietly on the CPU: a run on the host is asked for
by name (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The ``torch.device`` an entry point counts on.

    Args:
        device: ``None`` (the CUDA card), a device string or a
            ``torch.device``.

    Raises:
        RuntimeError: a CUDA device was asked for (or defaulted to) and
            none is available.

    Usage::

        dev = resolve_device("cpu")
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device=\"cpu\" to count "
                "on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (no-op on the host)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
