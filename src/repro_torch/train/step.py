"""Train and serve step factories; the JAX package's ``repro.train.step``.

``make_train_step`` builds ``(state, batch) -> (state, metrics)`` with
microbatch gradient accumulation (``cfg.microbatch`` slices of the batch,
their gradients summed into a float32 accumulator, not into ``p.grad`` in
the parameters' dtype) and the optimizer update.  The port's model holds
its weights, so ``state["params"]`` is the model's own parameters by name
(:func:`init_train_state`) and the serving steps take no parameters.

Over a training mesh (``init_train_state(..., mesh=mesh)`` shards the
model, :meth:`LM.shard_`) every rank runs the same step on its own
shards: it takes this rank's part of the batch (``batch_spec``; the
microbatches are the global batch's, as the reference's reshape of the
global batch makes them, :func:`_microbatches`), the accumulator and the
optimizer's state stay in the parameters' placement
(:func:`constrain_like_params`), gradients of parameters the FSDP axes do
not split are summed over them once a step, and the optimizer's norms and
statistics are taken over the whole tensors.  ``make_decode_step(model,
mesh)`` decodes over a cache whose sequence axis is split over ``model``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..models.config import ModelConfig
from ..models.model import LM
from ..models.pspec import current_mesh
from ..optim.adamw import AdamW, OptConfig, make_optimizer
from ..parallel.collectives import all_reduce
from ..parallel.mesh import spec_of
from .sharding import (batch_spec, mesh_axes, param_shardings, shard,
                       spec_axes, spec_for_param, unshard)

__all__ = ["ModelConfig", "LM", "AdamW", "OptConfig", "make_optimizer",
           "mesh_axes", "spec_for_param", "constrain_like_params",
           "init_train_state", "make_train_step", "make_loss_step",
           "make_prefill_step", "make_decode_step", "state_specs"]


def constrain_like_params(tree: Dict[str, torch.Tensor], mesh=None
                          ) -> Dict[str, torch.Tensor]:
    """A parameter-shaped tree (a gradient accumulator, compressed
    gradients) of whole tensors, cut to the parameters' placement on
    ``mesh`` (or the ambient mesh): each rank's shard by
    ``spec_for_param``.  Outside any mesh it is returned as it is."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return tree
    return {n: shard(x, spec_for_param(n, tuple(x.shape), mesh), mesh)
            for n, x in tree.items()}


def init_train_state(model: LM, opt, generator: torch.Generator,
                     mesh=None) -> Dict[str, Any]:
    """Random weights from ``generator`` (:meth:`LM.init`) and the
    optimizer's state: ``{"params": {name: parameter}, "opt": ...}``.  The
    model must be built ``trainable``.  With ``mesh`` every rank draws the
    same whole weights and keeps its shards (:meth:`LM.shard_`), and the
    optimizer's state is made beside the shards."""
    model.init(generator)
    if mesh is not None:
        model.shard_(mesh, param_shardings(dict(model.named_parameters()),
                                           mesh))
    params = dict(model.named_parameters())
    if not all(p.requires_grad for p in params.values()):
        raise ValueError("init_train_state: build the model with "
                         "trainable=True")
    return {"params": params, "opt": opt.init(params)}


def _batch_axis(name: str) -> int:
    """The batch axis of a batch leaf: 1 for M-RoPE's ``positions`` ``[3,
    B, S]``, else 0 (the reference's microbatch reshape)."""
    return 1 if name == "positions" else 0


def _split(batch: Dict[str, torch.Tensor], m: int):
    """``m`` microbatches: each tensor cut in ``m`` along its batch axis."""
    b = next(v.shape[_batch_axis(k)] for k, v in batch.items())
    if b % m:
        raise ValueError(f"batch of {b} does not split into {m} "
                         f"microbatches")
    parts = {k: v.chunk(m, dim=_batch_axis(k)) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(m)]


def _microbatches(batch: Dict[str, torch.Tensor], m: int, mesh=None):
    """``m`` microbatches of this rank's part of the batch.  Over a mesh,
    when this rank's row count is a multiple of the FSDP axes' size, its
    rows are its block of a global batch those axes split (``batch_spec``
    keeps a batch whole only where they do not divide it), and microbatch
    ``i`` is the global batch's ``i``-th slice of rows (the token rows
    gathered over those axes), cut to this rank's part as ``batch_spec``
    cuts it: the rows the reference's reshape of the global batch groups,
    which a loss that is not a mean over rows (MoE's auxiliary loss)
    needs.  Otherwise each rank slices its own rows."""
    if mesh is None or m == 1:
        return _split(batch, m)
    fsdp, _ = mesh_axes(mesh)
    n = mesh.axis_size(fsdp)
    if n == 1 or next(v.shape[_batch_axis(k)]
                      for k, v in batch.items()) % n:
        return _split(batch, m)
    whole = {k: unshard(v, (None,) * _batch_axis(k) + (fsdp,), mesh)
             for k, v in batch.items()}
    return [{k: shard(v, batch_spec(k, tuple(v.shape), mesh), mesh)
             for k, v in mb.items()} for mb in _split(whole, m)]


def make_train_step(model: LM, opt, compress: Optional[Callable] = None
                    ) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: the loss and
    gradients (over ``cfg.microbatch`` slices, mean loss, the last slice's
    metrics), the ``compress`` hook if any, then ``opt.update`` in place.
    ``metrics`` adds ``loss`` and the optimizer's ``lr`` (and
    ``grad_norm``) to the model's."""
    cfg = model.cfg
    mesh = model.mesh

    def grads_of(params, batch):
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), metrics, dict(zip(params, grads))

    def sum_over_data(params, grads):
        """Gradients the FSDP axes do not split summed over them (the
        FSDP-split ones came out of their gathers' reduce-scatter)."""
        fsdp, _ = mesh_axes(mesh)
        out = {}
        for name, g in grads.items():
            split = set(spec_axes(spec_of(params[name]))) - {"model"}
            for axis in fsdp:
                if axis not in split and mesh.shape[axis] > 1:
                    g = all_reduce(g.float(), mesh.group(axis)).to(g.dtype)
            out[name] = g
        return out

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        if cfg.microbatch > 1:
            m = cfg.microbatch
            acc = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(iter(params.values())).device)
            for mb in _microbatches(batch, m, mesh):
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
        if mesh is not None:
            grads = sum_over_data(params, grads)
        if compress is not None:
            grads, state = (compress(grads, state) if mesh is None else
                            compress(grads, state, params))
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
    """``decode(cache, batch) -> (logits, cache)``.  A sharded model
    decodes over its mesh (``mesh``, if given, must be the model's) with
    the cache's sequence axis split over ``model`` (``cache_spec``) and the
    softmax combined there (flash-decoding); the port keeps no other
    layout of a sharded cache, so ``seq_sharded=False`` over a mesh
    raises."""
    mesh = mesh if mesh is not None else model.mesh
    if mesh is not model.mesh:
        raise ValueError("decode over a mesh: shard the model over it "
                         "first (LM.shard_)")
    seq_axis = None
    if mesh is not None:
        if not seq_sharded:
            raise ValueError("a sharded model's decode cache is split along "
                             "its sequence axis (cache_spec): seq_sharded "
                             "must be True")
        seq_axis = mesh_axes(mesh)[1]

    def decode(cache, batch):
        return model.decode_step(cache, batch, seq_axis=seq_axis)
    return decode


def _leaf_specs(tree: Any, spec, prefix: str, out: Dict[str, Any]) -> None:
    """Every leaf under ``tree`` (one parameter's entry of a state) with
    the spec its tensor takes: the parameter's, or, for Adafactor's
    factors, the parameter's less the dim they average away."""
    if torch.is_tensor(tree):
        out[prefix] = spec
    elif isinstance(tree, dict):
        for k, v in tree.items():
            sub = {"r": None if spec is None else spec[:-1],
                   "c": None if spec is None else spec[:-2] + spec[-1:]
                   }.get(k, spec)
            _leaf_specs(v, sub, f"{prefix}[{k!r}]", out)


def state_specs(state: Any, params: Dict[str, torch.Tensor],
                prefix: str = "") -> Dict[str, Any]:
    """``{checkpoint path: spec}`` of a train state's leaves (the paths the
    checkpoint store spells): a leaf under a parameter's name (the
    parameter, its moments, Adafactor's factors, the error-feedback
    buffer) takes that parameter's spec, every other leaf is
    replicated."""
    out: Dict[str, Any] = {}
    if isinstance(state, dict):
        for k, v in state.items():
            path = f"{prefix}[{k!r}]"
            if k in params:
                _leaf_specs(v, spec_of(params[k]), path, out)
            else:
                out.update(state_specs(v, params, path))
    elif torch.is_tensor(state):
        out[prefix] = None
    return out
