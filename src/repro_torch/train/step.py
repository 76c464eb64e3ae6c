"""Train and serve step factories; the JAX package's ``repro.train.step`` on
one device.

``make_train_step`` builds ``(state, batch) -> (state, metrics)`` with
microbatch gradient accumulation (``cfg.microbatch`` slices of the batch,
their gradients summed into a float32 accumulator, not into ``p.grad`` in
the parameters' dtype) and the optimizer update.  The port's model holds
its weights, so ``state["params"]`` is the model's own parameters by name
(:func:`init_train_state`) and the serving steps take no parameters.
Sharding the state over ranks (the reference's ``train/sharding.py``)
waits for multi-rank training (ROADMAP item 14).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..models.config import ModelConfig
from ..models.model import LM
from ..optim.adamw import AdamW, OptConfig, make_optimizer

__all__ = ["ModelConfig", "LM", "AdamW", "OptConfig", "make_optimizer",
           "init_train_state", "make_train_step", "make_loss_step",
           "make_prefill_step", "make_decode_step"]


def init_train_state(model: LM, opt, generator: torch.Generator
                     ) -> Dict[str, Any]:
    """Random weights from ``generator`` (:meth:`LM.init`) and the
    optimizer's state: ``{"params": {name: parameter}, "opt": ...}``.  The
    model must be built ``trainable``."""
    model.init(generator)
    params = dict(model.named_parameters())
    if not all(p.requires_grad for p in params.values()):
        raise ValueError("init_train_state: build the model with "
                         "trainable=True")
    return {"params": params, "opt": opt.init(params)}


def _split(batch: Dict[str, torch.Tensor], m: int):
    """``m`` microbatches: each tensor cut in ``m`` along its batch axis."""
    b = next(iter(batch.values())).shape[0]
    if b % m:
        raise ValueError(f"batch of {b} does not split into {m} "
                         f"microbatches")
    parts = {k: v.chunk(m) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(m)]


def make_train_step(model: LM, opt, compress: Optional[Callable] = None
                    ) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: the loss and
    gradients (over ``cfg.microbatch`` slices, mean loss, the last slice's
    metrics), the ``compress`` hook if any, then ``opt.update`` in place.
    ``metrics`` adds ``loss`` and the optimizer's ``lr`` (and
    ``grad_norm``) to the model's."""
    cfg = model.cfg

    def grads_of(params, batch):
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), metrics, dict(zip(params, grads))

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        if cfg.microbatch > 1:
            m = cfg.microbatch
            acc = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(iter(params.values())).device)
            for mb in _split(batch, m):
                mb_loss, metrics, grads = grads_of(params, mb)
                for name, g in grads.items():
                    acc[name].add_(g)
                loss = loss + mb_loss
                del grads
            for a in acc.values():
                a.div_(m)
            grads, loss = acc, loss / m
        else:
            loss, metrics, grads = grads_of(params, batch)
        if compress is not None:
            grads, state = compress(grads, state)
        new_params, new_opt, opt_metrics = opt.update(params, grads,
                                                      state["opt"])
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return {"params": new_params, "opt": new_opt, **{
            k: v for k, v in state.items()
            if k not in ("params", "opt")}}, metrics

    return train_step


def make_loss_step(model: LM) -> Callable:
    """``step(batch) -> loss`` (the model's own weights)."""
    def step(batch):
        return model.loss(batch)[0]
    return step


def make_prefill_step(model: LM) -> Callable:
    """``prefill(batch, cache=None) -> (last logits, cache)``."""
    def prefill(batch, cache=None):
        return model.prefill(batch, cache)
    return prefill


def make_decode_step(model: LM, mesh=None, seq_sharded: bool = True
                     ) -> Callable:
    """``decode(cache, batch) -> (logits, cache)``.  A sequence-sharded
    cache over a mesh is not ported (ROADMAP item 14)."""
    if mesh is not None and seq_sharded:
        raise NotImplementedError("a decode step over a sequence-sharded "
                                  "cache is not ported yet (ROADMAP item "
                                  "14)")

    def decode(cache, batch):
        return model.decode_step(cache, batch)
    return decode
