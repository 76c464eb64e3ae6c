"""AdamW and Adafactor with warmup-cosine and global-norm clipping; the JAX
package's ``repro.optim.adamw`` on tensors.

Parameters, gradients and moments are dicts of tensors keyed by parameter
name (``dict(model.named_parameters())``).  The arithmetic is the JAX
package's: the update in float32 from float32 copies, weight decay added
to the update before the learning rate (not ``torch.optim.AdamW``'s
separate ``p * (1 - lr * wd)``), the parameter rounded to its dtype once,
moments kept in ``state_dtype``.  Where JAX returns new arrays, ``update``
writes the new parameters and moments into the given tensors in place
(one copy of the state on the card, not two) and returns them.

Adafactor factors the second moment of every leaf of two or more
dimensions over its last two axes, as in the JAX package; the port holds
each layer's weights apart, where the JAX LM stacks them ``[L, ...]``, so
on an LM the two factor a layer's vectors (norms, biases) differently.

Over a training mesh (each parameter of a sharded model carries its
``spec`` and its ``mesh``, ``LM.shard_``) every rank updates its shards: the
global norm counts each element once (a replicated parameter on one rank
of each axis it is replicated along), and Adafactor's row and column
means, their mean and the update's RMS are taken over the whole tensor,
so clipping and updates equal one rank's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from ..parallel.collectives import all_reduce
from ..parallel.mesh import param_layout, spec_axes

Tensors = Mapping[str, torch.Tensor]


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: str = "float32"
    kind: str = "adamw"            # adamw | adafactor


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (float32): linear warmup over
    ``warmup_steps``, then a cosine from ``lr`` down to ``0.1 lr`` at
    ``total_steps``."""
    step = step.float()
    warm = torch.clamp(step / max(1.0, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1.0, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _decay_mask(name: str) -> bool:
    """Weight decay for parameter ``name`` (dotted, as ``named_parameters``
    gives it): the JAX package's test on the leaf's own name, so norms are
    not decayed and the embedding and the QKV biases (``bq``, ``bk``,
    ``bv``: none of the tokens below matches them) are."""
    leaf = name.rsplit(".", 1)[-1]
    return not any(t in leaf for t in ("norm", "mu_", "bias", "b_", "ln_",
                                       "a_log", "d_skip", "decay_base",
                                       "u_bonus"))


def _sum_over(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """``x`` summed over the ranks of ``axes``, one spec entry (a name, a
    tuple of names or ``None``)."""
    for axis in spec_axes((axes,)):
        if mesh.shape[axis] > 1:
            x = all_reduce(x, mesh.group(axis))
    return x


def global_norm(tree: Tensors, mesh=None,
                specs: Optional[Mapping[str, Any]] = None) -> torch.Tensor:
    """``sqrt(sum of squares)`` of every tensor, in float32.  Over
    ``mesh`` the tensors are shards laid out by ``specs``: each element
    counts once over the whole mesh."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in tree.values()))
    total = None
    for name, x in tree.items():
        split = set(spec_axes(specs.get(name)))
        keep = all(mesh.coords[a] == 0 for a in mesh.axis_names
                   if a not in split)
        sq = torch.sum(torch.square(x.float()))
        sq = sq if keep else torch.zeros_like(sq)
        total = sq if total is None else total + sq
    return torch.sqrt(_sum_over(total, mesh.axis_names, mesh))


class AdamW:
    """AdamW over a dict of parameters (:func:`make_optimizer`)."""

    def __init__(self, cfg: OptConfig):
        self.cfg = cfg

    def init(self, params: Tensors) -> Dict[str, Any]:
        """Zero moments in ``state_dtype`` beside each parameter, and the
        step (int32, 0)."""
        dt = getattr(torch, self.cfg.state_dtype)
        first = next(iter(params.values()))
        return {"m": {n: torch.zeros_like(p, dtype=dt)
                      for n, p in params.items()},
                "v": {n: torch.zeros_like(p, dtype=dt)
                      for n, p in params.items()},
                "step": torch.zeros((), dtype=torch.int32,
                                    device=first.device)}

    @torch.no_grad()
    def update(self, params: Tensors, grads: Tensors, state: Dict[str, Any]):
        """One step: ``(params, state, {"lr", "grad_norm"})``, the
        parameters and moments updated in place."""
        cfg = self.cfg
        step = state["step"] + 1
        lr = schedule(cfg, step)
        mesh, specs = param_layout(params)
        gnorm = global_norm(grads, mesh, specs)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        b1, b2 = cfg.betas
        bc1 = 1.0 - b1 ** step.float()
        bc2 = 1.0 - b2 ** step.float()
        for name, p in params.items():
            m, v = state["m"][name], state["v"][name]
            g = grads[name].float() * scale
            m32 = b1 * m.float() + (1 - b1) * g
            v32 = b2 * v.float() + (1 - b2) * g * g
            upd32 = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
            if _decay_mask(name):
                upd32 = upd32 + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * upd32)
            m.copy_(m32)
            v.copy_(v32)
        state["step"] = step
        return params, state, {"lr": lr, "grad_norm": gnorm}


class Adafactor:
    """Factored second moment (row/col): O(n+m) state for matrices."""

    def __init__(self, cfg: OptConfig):
        self.cfg = cfg

    def init(self, params: Tensors) -> Dict[str, Any]:
        def factored(p):
            if p.dim() >= 2:
                return {"r": p.new_zeros(p.shape[:-1], dtype=torch.float32),
                        "c": p.new_zeros(p.shape[:-2] + p.shape[-1:],
                                         dtype=torch.float32)}
            return {"v": p.new_zeros(p.shape, dtype=torch.float32)}
        first = next(iter(params.values()))
        return {"f": {n: factored(p) for n, p in params.items()},
                "step": torch.zeros((), dtype=torch.int32,
                                    device=first.device)}

    @torch.no_grad()
    def update(self, params: Tensors, grads: Tensors, state: Dict[str, Any]):
        """One step: ``(params, state, {"lr"})``, the parameters and
        factors updated in place."""
        cfg = self.cfg
        step = state["step"] + 1
        lr = schedule(cfg, step)
        d = 1.0 - 0.8 ** step.float()            # beta2 ramp
        mesh, specs = param_layout(params)

        def mean(x, dim, keepdim=False, spec=None):
            """``x.mean(dim)`` over the whole tensor's extent of ``dim``."""
            if mesh is None or spec is None or spec[dim] is None:
                return x.mean(dim=dim, keepdim=keepdim)
            n = x.shape[dim] * mesh.axis_size(spec[dim])
            return _sum_over(x.sum(dim=dim, keepdim=keepdim), spec[dim],
                             mesh) / n

        for name, p in params.items():
            f = state["f"][name]
            spec = specs[name]
            g32 = grads[name].float()
            sq = g32 * g32 + 1e-30
            if p.dim() >= 2:
                r = d * f["r"] + (1 - d) * mean(sq, -1, spec=spec)
                c = d * f["c"] + (1 - d) * mean(sq, -2, spec=spec)
                r_mean = mean(r, -1, keepdim=True,
                              spec=None if spec is None else spec[:-1])
                denom = torch.sqrt(r[..., None] * c[..., None, :]
                                   / torch.clamp(r_mean[..., None],
                                                 min=1e-30))
                f["r"].copy_(r)
                f["c"].copy_(c)
            else:
                v = d * f["v"] + (1 - d) * sq
                denom = torch.sqrt(v)
                f["v"].copy_(v)
            upd32 = g32 / torch.clamp(denom, min=1e-30)
            # relative update clipping
            sq_upd = upd32 * upd32
            if mesh is None or spec is None:
                ms = torch.mean(sq_upd)
            else:
                axes = spec_axes(spec)
                ms = _sum_over(sq_upd.sum(), axes, mesh) / (
                    sq_upd.numel() * mesh.axis_size(axes))
            rms = torch.sqrt(ms + 1e-30)
            upd32 = upd32 / torch.clamp(rms, min=1.0)
            p.copy_(p.float() - lr * upd32)
        state["step"] = step
        return params, state, {"lr": lr}


def make_optimizer(cfg: OptConfig):
    return Adafactor(cfg) if cfg.kind == "adafactor" else AdamW(cfg)
