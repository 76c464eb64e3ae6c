"""Mamba-2/SSD-style selective-state-space heads for Hymba; the JAX
package's ``repro.models.ssm``.

A scalar decay per head (state ``N = cfg.ssm_state`` key channels), so the
sequence mix is the chunked linear attention shared with RWKV, with ``C``
as the query, ``B`` as the key, the value scaled by the time step and no
bonus; O(1)-state decode.  As in the reference, Mamba's depthwise
convolution is left out.

Over a training mesh (``mesh``; ``train/sharding.py``'s rules) ``w_in``,
``w_gate`` and ``w_bc`` are column-parallel over ``model``, ``w_out``
row-parallel, and ``w_dt``, ``a_log`` and ``d_skip`` whole on every rank.
The route is :func:`linear_attention_route`'s.  On ``"heads"`` (the heads
divide ``model``) each rank's columns are its heads: it runs the core on
them with its slice of ``dt``, ``a_log`` and ``d_skip``, and feeds
``w_out`` its columns of ``y``.  Otherwise the head reshape needs the
projections whole (Hymba-1.5B's 25 heads of 64 split over 2 ranks at 12.5
heads), so they are gathered first and the core takes the ``"chunks"``
route (or, when the chunks do not divide ``model`` either, runs whole on
every rank).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import copy_to, gather, split
from .attention import out_project
from .config import ModelConfig
from .layers import dense_init, is_tp, model_group, parameter, weight
from .linear_attn import (chunked_linear_attention, linear_attention_decode,
                          linear_attention_route)


def _dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    h = cfg.ssm_heads
    hd = cfg.hd
    return h, hd, h * hd     # heads, head value dim, inner dim


class SsmParams(nn.Module):
    """``w_in``/``w_gate`` [D, dI] (the value path and its silu gate),
    ``w_bc`` [D, 2N*H] (B and C per head), ``w_dt`` [D, H] (float32),
    ``a_log`` [H] and ``d_skip`` [dI] (float32), ``w_out`` [dI, D]; the
    projections in the param dtype, uninitialised until :meth:`init_`;
    trainable weights take gradients."""

    FIELDS = ("w_in", "w_gate", "w_bc", "w_dt", "a_log", "d_skip", "w_out")

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 trainable: bool = False):
        super().__init__()
        d, n = cfg.d_model, cfg.ssm_state
        h, _, di = _dims(cfg)
        dt, f32 = cfg.p_dtype(), torch.float32
        shapes = dict(w_in=((d, di), dt), w_gate=((d, di), dt),
                      w_bc=((d, 2 * n * h), dt), w_dt=((d, h), f32),
                      a_log=((h,), f32), d_skip=((di,), f32),
                      w_out=((di, d), dt))
        for name in self.FIELDS:
            shape, dtype = shapes[name]
            setattr(self, name, parameter(shape, dtype, device, trainable))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "SsmParams":
        """``ssm_init``'s values: ``a_log`` 0, ``d_skip`` 1, the
        projections ``N(0, 1)`` scaled by ``d_in**-0.5``, drawn in
        float32."""
        for name in ("w_in", "w_gate", "w_bc", "w_dt", "w_out"):
            w = getattr(self, name)
            w.copy_(dense_init(generator, *w.shape, w.dtype))
        self.a_log.zero_()
        self.d_skip.fill_(1.0)
        return self


def ssm_init(generator: torch.Generator, cfg: ModelConfig) -> SsmParams:
    return SsmParams(cfg, generator.device).init_(generator)


def _projections(x: torch.Tensor, ws, mesh, heads: bool):
    """``x @ w`` for each ``w`` of ``ws`` as the route reads it:
    column-parallel where ``model`` splits ``w`` (from ``x`` through
    ``copy_to``).  On the ``"heads"`` route those columns are this rank's
    heads; on the others the split products are gathered whole, all in one
    collective, and every rank reads them alike."""
    grp = model_group(mesh)
    if grp is None:
        return [x @ weight(w, mesh, x.dtype) for w in ws]
    xc = copy_to(x, grp)
    split_w = [is_tp(w) for w in ws]
    ys = [(xc if sp else x) @ weight(w, mesh, x.dtype)
          for w, sp in zip(ws, split_w)]
    if heads or not any(split_w):
        return ys
    parts = [y for y, sp in zip(ys, split_w) if sp]
    whole = gather(torch.cat(parts, dim=-1), x.dim() - 1, grp, "split")
    # rank-major: each rank's columns of every part, then the next rank's
    pieces = iter(t.flatten(-2) for t in whole.unflatten(
        -1, (mesh.shape["model"], -1)).split([t.shape[-1] for t in parts],
                                            dim=-1))
    return [next(pieces) if sp else y for y, sp in zip(ys, split_w)]


def _project(p: SsmParams, x: torch.Tensor, cfg: ModelConfig, mesh=None,
             heads: bool = True):
    """``x [..., D]`` -> ``(v [..., H, hd]`` float32 scaled by ``dt``,
    ``B``, ``C [..., H, N]`` float32, ``logw [..., H]``, ``xv``, ``gate``,
    ``d_skip)``.  Over a mesh, on the ``"heads"`` route (``heads``) each
    is this rank's heads' part, else all of it (module docstring)."""
    lead = x.shape[:-1]
    n = cfg.ssm_state
    _, hd, _ = _dims(cfg)
    grp = model_group(mesh)
    xv, gate, bc = _projections(x, (p.w_in, p.w_gate, p.w_bc), mesh, heads)
    bc = bc.float().reshape(lead + (-1, 2 * n))
    bmat, cmat = bc[..., :n], bc[..., n:]
    dt = F.softplus(x.float() @ weight(p.w_dt, mesh))    # [.., H]
    a_log, d_skip = p.a_log, p.d_skip
    if grp is not None and heads:                        # this rank's heads
        dt, a_log, d_skip = (split(t, t.dim() - 1, grp)
                             for t in (dt, a_log, d_skip))
    logw = dt * -torch.exp(a_log)                        # [.., H] < 0
    v = xv.reshape(lead + (-1, hd)).float() * dt[..., None]
    return v, bmat, cmat, logw, xv, gate, d_skip


def _skip_gate_out(p: SsmParams, o: torch.Tensor, xv: torch.Tensor,
                   gate: torch.Tensor, d_skip: torch.Tensor,
                   dtype: torch.dtype, mesh=None) -> torch.Tensor:
    """``(o + xv * d_skip)`` (float32) in ``dtype``, gated by
    ``silu(gate)``, through ``w_out`` (:func:`out_project`: row-parallel
    where ``model`` splits it)."""
    y = o + xv.float() * d_skip
    y = y.to(dtype) * F.silu(gate.float()).to(dtype)
    return out_project(p.w_out, y, mesh)


def _route(cfg: ModelConfig, s: int, mesh) -> str:
    grp = model_group(mesh)
    return linear_attention_route(cfg.ssm_heads, s,
                                  1 if grp is None else mesh.shape["model"])


def ssm_apply(p: SsmParams, x: torch.Tensor, cfg: ModelConfig,
              state: Optional[torch.Tensor] = None, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], state [B, H, N, hd] float32; over a
    mesh, this rank's heads of the state on the ``"heads"`` route)."""
    b, s, _ = x.shape
    n = cfg.ssm_state
    route = _route(cfg, s, mesh)
    v, bmat, cmat, logw, xv, gate, d_skip = _project(
        p, x, cfg, mesh, route == "heads")
    h = logw.shape[-1]
    logw_k = logw[..., None].expand(b, s, h, n)
    o, s1 = chunked_linear_attention(
        cmat, bmat, v, logw_k, u=None, chunk=64, state0=state,
        mesh=mesh if route == "chunks" else None)
    return _skip_gate_out(p, o.reshape(b, s, -1), xv, gate, d_skip,
                          x.dtype, mesh), s1


def ssm_decode(p: SsmParams, x1: torch.Tensor, cfg: ModelConfig,
               state: torch.Tensor, mesh=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x1 [B, D]; state [B, H, N, hd] (over a mesh, as :func:`ssm_apply`
    keeps it) -> (y [B, D], new state)."""
    b = x1.shape[0]
    n = cfg.ssm_state
    heads = _route(cfg, 1, mesh) == "heads"
    v, bmat, cmat, logw, xv, gate, d_skip = _project(p, x1, cfg, mesh,
                                                     heads)
    h = logw.shape[-1]
    o, s1 = linear_attention_decode(cmat, bmat, v,
                                    logw[..., None].expand(b, h, n), state,
                                    u=None)
    return _skip_gate_out(p, o.reshape(b, -1), xv, gate, d_skip, x1.dtype,
                          mesh), s1
