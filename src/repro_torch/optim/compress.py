"""Int8 gradient compression with error feedback; the JAX package's
``repro.optim.compress`` on dicts of tensors.

Gradients are quantised to int8 with a per-tensor scale and dequantised;
the quantisation residual is carried in an error-feedback buffer and added
back the next step, which keeps SGD-style convergence.  Used as the
``compress`` hook of :func:`repro_torch.train.step.make_train_step`: it
transforms the gradients and threads its buffer through the train state
under ``"ef"``.  ``torch.round``, like ``jnp.round``, rounds half to even,
so the codes and the buffer equal the JAX package's bit for bit.  Over a
training mesh the gradients are shards of the parameters (``params``,
which carry their ``spec`` and ``mesh``): each tensor's scale is
its largest magnitude over the whole tensor (a max over the axes that
split it), so a compressed step equals one rank's.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from ..parallel.collectives import all_reduce
from ..parallel.mesh import param_layout, spec_axes


def _quant(g32: torch.Tensor, mesh=None, spec=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    top = g32.abs().max()
    if mesh is not None:
        for axis in spec_axes(spec):         # the axes that split g32
            if mesh.shape[axis] > 1:
                top = all_reduce(top, mesh.group(axis), "max")
    scale = torch.clamp(top, min=1e-30) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """A zero float32 buffer beside each parameter."""
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.items()}


def make_compressor():
    """Returns ``compress(grads, state) -> (grads', state')`` for
    ``make_train_step``."""

    @torch.no_grad()
    def compress(grads: Mapping[str, torch.Tensor], state: Dict[str, Any],
                 params: Optional[Mapping[str, torch.Tensor]] = None):
        """``params``: the parameters the gradients are of, where those
        are shards of a sharded model (:func:`param_layout` reads their
        mesh and specs); ``None`` for whole tensors."""
        mesh, specs = param_layout(params or {})
        ef = state.get("ef")
        if ef is None:
            ef = init_error_feedback(grads)
        new_g, new_ef = {}, {}
        for name, g in grads.items():
            g32 = g.float() + ef[name]
            deq = _dequant(*_quant(g32, mesh, specs.get(name)))
            new_g[name] = deq.to(g.dtype)
            new_ef[name] = g32 - deq
        return new_g, {**state, "ef": new_ef}

    return compress


def compression_ratio_bits() -> float:
    return 32.0 / 8.0
