"""Sharding rules; the JAX package's ``repro.train.sharding`` for ranks of
a ``torch.distributed`` group.

2-D scheme: tensor-parallel over ``model`` on heads/ffn/vocab dims, FSDP
over the ``data`` axis (``('pod', 'data')`` on a mesh with a ``pod`` axis)
on the d_model/embed dim.  Dims that do not divide the mesh axis are
replicated; the rule checks divisibility against the actual mesh.

A spec is what a ``PartitionSpec`` holds: one entry per dim, each a mesh
axis name, a tuple of them, or ``None`` (replicated).  Parameter leaf names
are the contract with ``models/*``: rules key on the trailing-dims
semantics of each named leaf.  The port holds each layer's weights apart
(``blocks.3.attn.wq``), where the JAX LM stacks them ``[L, ...]``; a stacked
leaf's leading axis gets ``None``, so a layer's spec is the stacked leaf's
without it.

The mesh and the cut of a tensor to its shard (:class:`Mesh`,
:func:`shard`, :func:`unshard`) live below the models, in
:mod:`repro_torch.parallel.mesh`, and are re-exported here.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from ..parallel.mesh import (Mesh, Spec, abstract_mesh, local_shape,
                             mesh_axes, shard, spec_axes, unshard)

__all__ = ["Mesh", "Spec", "abstract_mesh", "mesh_axes", "spec_for_param",
           "param_shardings", "batch_spec", "batch_shardings",
           "cache_spec", "cache_shardings", "logits_sharding",
           "local_shape", "shard", "unshard", "spec_axes", "shard_batch"]


def _leaf_name(path) -> str:
    """The last key of a dotted name (``blocks.0.attn.wq`` -> ``wq``) or of
    a sequence of keys."""
    if isinstance(path, str):
        return path.rsplit(".", 1)[-1]
    return str(path[-1]) if len(path) else ""


def _path_str(path) -> str:
    return path if isinstance(path, str) else ".".join(map(str, path))


# trailing-dim spec templates per leaf name: "F" = fsdp, "T" = tp, "-" = none
_RULES: Dict[str, Tuple[str, ...]] = {
    # embeddings
    "embed": ("T", "F"),
    # attention
    "wq": ("F", "T"), "wk": ("F", "T"), "wv": ("F", "T"), "wo": ("T", "F"),
    "bq": ("T",), "bk": ("T",), "bv": ("T",),
    # mlp
    "wi": ("F", "T"), "wg": ("F", "T"),
    # moe (leading E dim -> expert parallel over tp)
    "router": ("F", "-"),
    "moe_wi": ("T", "F", "-"), "moe_wg": ("T", "F", "-"),
    "moe_wo": ("T", "-", "F"),
    # rwkv
    "wr": ("F", "T"), "w_decay": ("F", "T"),
    "ck": ("F", "T"), "cv": ("T", "F"), "cr": ("F", "T"),
    # ssm
    "w_in": ("F", "T"), "w_gate": ("F", "T"), "w_bc": ("F", "T"),
    "w_dt": ("F", "-"), "w_out": ("T", "F"),
}


def spec_for_param(path, shape: Sequence[int], mesh: Mesh) -> Spec:
    """The spec of the parameter at ``path`` (a dotted name as
    ``named_parameters`` gives it, or a sequence of keys) of global
    ``shape`` on ``mesh``."""
    fsdp, tp = mesh_axes(mesh)
    name = _leaf_name(path)
    ndim = len(shape)
    if ndim == 0:
        return ()
    rule: Optional[Tuple[str, ...]] = None
    if "moe" in _path_str(path) and name in ("wi", "wg", "wo"):
        rule = _RULES["moe_" + name]
    elif name in _RULES:
        rule = _RULES[name]
    if rule is None or ndim < len(rule):
        return (None,) * ndim              # norms, biases, mus, scalars
    lead = ndim - len(rule)
    spec = [None] * lead
    for sym, dim in zip(rule, shape[lead:]):
        if sym == "F":
            spec.append(fsdp if dim % mesh.axis_size(fsdp) == 0 else None)
        elif sym == "T":
            spec.append(tp if dim % mesh.axis_size(tp) == 0 else None)
        else:
            spec.append(None)
    return tuple(spec)


def param_shardings(params: Mapping[str, Any], mesh: Mesh
                    ) -> Dict[str, Spec]:
    """``{name: spec}`` for a dict of parameters (tensors, or anything with
    a ``shape``), their global shapes."""
    return {name: spec_for_param(name, tuple(p.shape), mesh)
            for name, p in params.items()}


# ----------------------------------------------------------- activations ---

def batch_spec(name: str, shape, mesh: Mesh, decode: bool = False) -> Spec:
    """Spec of one input-batch leaf."""
    fsdp, _ = mesh_axes(mesh)
    bdiv = lambda d: fsdp if d % mesh.axis_size(fsdp) == 0 else None
    nd = len(shape)
    if name == "positions":                       # [3, B, S]
        return (None, bdiv(shape[1]), None)
    if name == "pos" or nd == 0:
        return ()
    if name in ("tokens", "labels", "token"):     # [B, S]
        return (bdiv(shape[0]), None)
    if name in ("embeds", "frames", "embed1"):    # [B, S, D]
        return (bdiv(shape[0]), None, None)
    return (None,) * nd


def batch_shardings(batch: Mapping[str, Any], mesh: Mesh) -> Dict[str, Spec]:
    return {k: batch_spec(k, tuple(getattr(v, "shape", ())), mesh)
            for k, v in batch.items()}


def cache_spec(name: str, shape, mesh: Mesh) -> Spec:
    """Decode-cache leaf specs: KV sequence axis sharded over ``model``
    (flash-decoding), recurrent states sharded over heads when
    divisible."""
    fsdp, tp = mesh_axes(mesh)
    bdiv = lambda d: fsdp if d % mesh.axis_size(fsdp) == 0 else None
    tdiv = lambda d: tp if d % mesh.axis_size(tp) == 0 else None
    if name in ("k", "v"):          # [L, B, S, Hkv, hd]
        return (None, bdiv(shape[1]), tp, None, None)
    if name in ("xk", "xv"):        # [L, B, F, Hkv, hd] cross-attn (static)
        return (None, bdiv(shape[1]), None, None, None)
    if name == "wkv":               # [L, B, H, dk, dv]
        return (None, bdiv(shape[1]), tdiv(shape[2]), None, None)
    if name == "ssm":               # [L, B, H, N, hd]
        return (None, bdiv(shape[1]), tdiv(shape[2]), None, None)
    if name in ("tm_x", "cm_x"):    # [L, B, D]
        return (None, bdiv(shape[1]), None)
    return (None,) * len(shape)


def cache_shardings(cache: Mapping[str, Any], mesh: Mesh) -> Dict[str, Spec]:
    return {k: cache_spec(k, tuple(v.shape), mesh) for k, v in cache.items()}


def logits_sharding(mesh: Mesh, batch_dim: int,
                    vocab: Optional[int] = None) -> Spec:
    """``[B, V]`` logits: batch over fsdp, vocab over tp, each only when the
    dim divides the axis."""
    fsdp, tp = mesh_axes(mesh)
    b_ax = fsdp if batch_dim % mesh.axis_size(fsdp) == 0 else None
    v_ax = tp if vocab is None or vocab % mesh.axis_size(tp) == 0 else None
    return (b_ax, v_ax)


# ------------------------------------------------------ shards of tensors ---

def shard_batch(batch: Mapping[str, torch.Tensor], mesh: Mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's part of a global batch, as :func:`batch_spec` lays it
    out (what the data pipeline gives a data rank with ``hosts`` = the
    data axis and ``host_id`` = its index there)."""
    return {k: shard(v, batch_spec(k, tuple(v.shape), mesh), mesh)
            if torch.is_tensor(v) else v for k, v in batch.items()}
