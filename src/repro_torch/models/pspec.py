"""Activation layouts under the ambient training mesh; the JAX package's
``repro.models.pspec``.

``with use_mesh(mesh):`` makes ``mesh`` (a
:class:`repro_torch.parallel.mesh.Mesh`) the ambient mesh, as JAX's
``set_mesh`` does; :func:`current_mesh` reads it.  ``constrain(x, "B",
"T", None, ...)`` lays out an activation that every rank holds whole as
its dims say: "B" -> this rank's block along the FSDP/batch axes
(``('pod', 'data')`` or ``('data',)``), "T" -> its block along
``model``, ``None`` -> whole.  Dims that do not divide the axis are left
whole.  The backward all-gathers the blocks' gradients, so the result is
differentiable.  Outside any mesh it is a no-op, so model code stays
portable.  The ambient mesh is one for the process (the autograd engine's
threads see it too).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch

from ..parallel.collectives import split

_STACK: list = []


@contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh inside the block (``None``: none)."""
    _STACK.append(mesh)
    try:
        yield mesh
    finally:
        _STACK.pop()


def current_mesh():
    """The ambient mesh, or ``None``."""
    return _STACK[-1] if _STACK else None


def constrain(x: torch.Tensor, *dims, mesh: Optional[object] = None
              ) -> torch.Tensor:
    """``x``, whole on every rank, cut to this rank's block as ``dims``
    say (module docstring), under ``mesh`` or the ambient mesh."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or mesh.groups is None:
        return x
    names = set(mesh.axis_names)
    fsdp = tuple(a for a in ("pod", "data") if a in names)
    for dim, (sym, size) in enumerate(zip(dims, x.shape)):
        if sym == "B" and fsdp:
            if size % mesh.axis_size(fsdp) == 0:
                for axis in fsdp:            # pod-major blocks
                    x = split(x, dim, mesh.group(axis))
        elif sym == "T" and "model" in names:
            if size % mesh.shape["model"] == 0:
                x = split(x, dim, mesh.group("model"))
    return x
