"""RWKV-6 (Finch) block: token mix with data-dependent vector decay and a
squared-ReLU channel mix, both with token shift; the JAX package's
``repro.models.rwkv``.

Decode state per layer: the previous token of each shift (the block's
normed input, as the full-sequence mixes return it) and the
``[H, dk, dv]`` wkv state, O(1) in the sequence length.  The "ln_x"
normalisation is an RMS over the whole ``D`` (not per head), as the
reference computes it.  The decay's projection runs in float32.

Over a training mesh (``mesh``; ``train/sharding.py``'s rules) the token
mix's projections and the decay's are column-parallel over ``model`` and
``wo`` row-parallel; ``decay_base``, ``u_bonus``, ``ln_x`` and the lerps
are whole on every rank.  The route is :func:`linear_attention_route`'s:
on ``"heads"`` each rank runs the core on its heads, takes its slice of
``decay_base``, ``u_bonus`` and ``ln_x``, and the "ln_x" RMS sums its
squares over ``model`` (one small all-reduce); on the others the
projections are gathered whole first.  The channel mix's ``ck`` and
``cr`` are column-parallel and ``cv`` row-parallel: ``rgate`` (this
rank's columns) is gathered and ``kv`` summed over ``model``.  The split
products take the normed input and the lerps through ``copy_to``, so
that their gradients are the sum of the ranks'.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import copy_to, gather, reduce, split
from .attention import out_project
from .config import ModelConfig
from .layers import dense_init, is_tp, model_group, parameter, weight
from .linear_attn import (chunked_linear_attention, linear_attention_decode,
                          linear_attention_route)

_MUS = ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g")
_PROJ = ("wr", "wk", "wv", "wg", "wo")


class RwkvParams(nn.Module):
    """The reference's 19 fields, in its order and dtypes: the token mix's
    lerp coefficients ``mu_r``/``mu_k``/``mu_v``/``mu_w``/``mu_g`` [D],
    projections ``wr``/``wk``/``wv``/``wg``/``wo`` and the decay's
    ``w_decay`` [D, D], ``decay_base`` [D], ``u_bonus`` [H, hd] and
    ``ln_x`` [D] (these three float32); the channel mix's ``mu_ck``/
    ``mu_cr`` [D], ``ck`` [D, F], ``cv`` [F, D] and ``cr`` [D, D].  The
    rest are in the param dtype; uninitialised until :meth:`init_`;
    trainable weights take gradients."""

    FIELDS = _MUS + _PROJ + ("w_decay", "decay_base", "u_bonus", "ln_x",
                             "mu_ck", "mu_cr", "ck", "cv", "cr")

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 trainable: bool = False):
        super().__init__()
        d, f, hd = cfg.d_model, cfg.d_ff, cfg.rwkv_head_dim
        dt, f32 = cfg.p_dtype(), torch.float32
        shapes = dict.fromkeys(_MUS + ("mu_ck", "mu_cr"), ((d,), dt))
        shapes.update(dict.fromkeys(_PROJ + ("w_decay", "cr"), ((d, d), dt)))
        shapes.update(decay_base=((d,), f32), u_bonus=((d // hd, hd), f32),
                      ln_x=((d,), f32), ck=((d, f), dt), cv=((f, d), dt))
        for name in self.FIELDS:
            shape, dtype = shapes[name]
            setattr(self, name, parameter(shape, dtype, device, trainable))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "RwkvParams":
        """``rwkv_init``'s values: the lerps 0.5, ``decay_base`` -2,
        ``u_bonus`` 0, ``ln_x`` 1; ``N(0, 1)`` scaled by ``d_in**-0.5``
        (``w_decay`` by 0.01, ``cv`` by ``F**-0.5``), drawn in float32."""
        for name in _MUS + ("mu_ck", "mu_cr"):
            getattr(self, name).fill_(0.5)
        for name in _PROJ + ("w_decay", "ck", "cv", "cr"):
            w = getattr(self, name)
            scale = {"w_decay": 0.01, "cv": w.shape[0] ** -0.5}.get(name)
            w.copy_(dense_init(generator, *w.shape, w.dtype, scale=scale))
        self.decay_base.fill_(-2.0)
        self.u_bonus.zero_()
        self.ln_x.fill_(1.0)
        return self


def rwkv_init(generator: torch.Generator, cfg: ModelConfig) -> RwkvParams:
    return RwkvParams(cfg, generator.device).init_(generator)


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros, or ``prev [B, D]``, at t=0).
    x [B, S, D]."""
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _mix(x: torch.Tensor, xs: torch.Tensor, mu: torch.Tensor
         ) -> torch.Tensor:
    return x + (xs - x) * mu.to(x.dtype)


def _products(p: RwkvParams, x: torch.Tensor, xs: torch.Tensor,
              triples, mesh):
    """``[(_mix(x, xs, p.<mu>) @ p.<w> in dtype, split)]`` for each ``(mu,
    w, dtype)`` of ``triples`` (``dtype`` ``None``: ``x``'s): ``split``
    says whether ``model`` splits the weight's columns, and then the
    product is column-parallel, this rank's columns, from ``x``, ``xs``
    and the lerp through ``copy_to`` (their gradients summed over
    ``model``: one all-reduce for ``x`` and ``xs`` and one for the lerps,
    whatever the number of products)."""
    grp = model_group(mesh)
    split_w = [grp is not None and is_tp(getattr(p, w)) for _, w, _ in triples]
    if any(split_w):
        xc, xsc = copy_to(x, grp), copy_to(xs, grp)
        mu_c = iter(copy_to(torch.stack([
            getattr(p, mu) for (mu, _, _), sp in zip(triples, split_w)
            if sp]), grp).unbind(0))
    out = []
    for (mu, w, dtype), sp in zip(triples, split_w):
        dtype = dtype or x.dtype
        m = (_mix(xc, xsc, next(mu_c)) if sp
             else _mix(x, xs, getattr(p, mu)))
        out.append((m.to(dtype) @ weight(getattr(p, w), mesh, dtype), sp))
    return out


def _whole(t: torch.Tensor, sharded: bool, mesh) -> torch.Tensor:
    """A projection ``t [..., C]`` with all its columns: gathered over
    ``model`` where ``sharded`` (every rank then reads them alike)."""
    return gather(t, t.dim() - 1, model_group(mesh), "split") if sharded \
        else t


def _ln_x_gate(p: RwkvParams, o: torch.Tensor, g: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """The float32 RMS of ``o`` over the whole ``D`` times ``ln_x``, gated
    by ``silu(g)``, in ``dtype``."""
    o32 = o.float()
    o32 = o32 * torch.rsqrt(torch.mean(o32 * o32, -1, keepdim=True) + 1e-6)
    return (o32 * p.ln_x).to(dtype) * F.silu(g.float()).to(dtype)


def _ln_x_gate_heads(p: RwkvParams, o: torch.Tensor, g: torch.Tensor,
                     dtype: torch.dtype, mesh) -> torch.Tensor:
    """:func:`_ln_x_gate` on this rank's heads' columns of ``o`` and ``g``
    (the ``"heads"`` route): the squares summed over ``model`` for the RMS
    over the whole ``D`` (and each rank's gradient of the sum summed
    there, since every rank's columns read it), ``ln_x`` this rank's
    slice."""
    grp = mesh.group("model")
    o32 = o.float()
    ss = copy_to(reduce((o32 * o32).sum(-1, keepdim=True), grp), grp)
    o32 = o32 * torch.rsqrt(ss / p.ln_x.shape[0] + 1e-6)
    return (o32 * split(p.ln_x, 0, grp)).to(dtype) * F.silu(
        g.float()).to(dtype)


def _gate(p: RwkvParams, o: torch.Tensor, g: torch.Tensor,
          dtype: torch.dtype, mesh) -> torch.Tensor:
    if o.shape[-1] == p.ln_x.shape[0]:
        return _ln_x_gate(p, o, g, dtype)
    return _ln_x_gate_heads(p, o, g, dtype, mesh)


_TOKEN = (("mu_r", "wr", None), ("mu_k", "wk", None), ("mu_v", "wv", None),
          ("mu_g", "wg", None), ("mu_w", "w_decay", torch.float32))


def _token_inputs(p: RwkvParams, x: torch.Tensor, xs: torch.Tensor,
                  h: int, mesh):
    """The route and the core's inputs ``r, k, v, g, logw [..., C]`` (C
    this rank's heads' columns on the ``"heads"`` route, else ``D``), and
    the bonus ``u`` of those heads.  The decay's projection is float32,
    ``-exp(clip(base + proj, -8, 4))``."""
    grp = model_group(mesh)
    tp = 1 if grp is None else mesh.shape["model"]
    route = linear_attention_route(h, x.shape[1] if x.dim() == 3 else 1, tp)
    heads = route == "heads"
    prods = _products(p, x, xs, _TOKEN, mesh)
    r, k, v, g, raw = (t if heads else _whole(t, sp, mesh)
                       for t, sp in prods)
    base, u = p.decay_base, p.u_bonus
    if heads and grp is not None:
        base, u = split(base, 0, grp), split(u, 0, grp)
    logw = -torch.exp(torch.clamp(base + raw, -8.0, 4.0))
    return route, r, k, v, g, logw, u


def rwkv_token_mix(p: RwkvParams, x: torch.Tensor, cfg: ModelConfig,
                   state: Optional[Tuple] = None, mesh=None
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                  torch.Tensor]]:
    """x [B, S, D] -> (out [B, S, D], (x[:, -1], wkv state [B, H, hd,
    hd])); ``state = (prev_x, S)`` continues a sequence.  Over a mesh the
    state holds this rank's heads on the ``"heads"`` route, all of them
    on the others."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    prev_x, s0 = (None, None) if state is None else state
    xs = _shift(x, prev_x)
    route, r, k, v, g, logw, u = _token_inputs(p, x, xs, d // hd, mesh)
    o, s1 = chunked_linear_attention(
        *(t.reshape(b, s, -1, hd) for t in (r, k, v, logw)), u=u,
        chunk=64, state0=s0, mesh=mesh if route == "chunks" else None)
    o = _gate(p, o.reshape(b, s, -1), g, x.dtype, mesh)
    return out_project(p.wo, o, mesh), (x[:, -1], s1)


def rwkv_channel_mix(p: RwkvParams, x: torch.Tensor,
                     prev_x: Optional[torch.Tensor] = None, mesh=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D], x[:, -1]).  Over a mesh ``kv`` is
    summed over ``model`` where ``model`` splits ``ck``/``cv``, and
    ``rgate`` gathered where it splits ``cr``."""
    xs = _shift(x, prev_x)
    (k, k_sp), (rg, rg_sp) = _products(
        p, x, xs, (("mu_ck", "ck", None), ("mu_cr", "cr", None)), mesh)
    k = torch.square(F.relu(k.float())).to(x.dtype)
    kv = k @ weight(p.cv, mesh, x.dtype)
    if k_sp:                    # F split over model: partial products
        kv = reduce(kv, model_group(mesh))
    rgate = torch.sigmoid(_whole(rg, rg_sp, mesh).float())
    return rgate.to(x.dtype) * kv, x[:, -1]


def rwkv_token_mix_decode(p: RwkvParams, x1: torch.Tensor, cfg: ModelConfig,
                          state: Tuple[torch.Tensor, torch.Tensor], mesh=None
                          ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                         torch.Tensor]]:
    """Single-token token mix.  x1 [B, D]; ``state = (prev_x [B, D], S)``
    (over a mesh, ``S`` as :func:`rwkv_token_mix` keeps it); returns
    ``(out [B, D], (x1, S'))``."""
    b, d = x1.shape
    hd = cfg.rwkv_head_dim
    prev_x, s0 = state
    _, r, k, v, g, logw, u = _token_inputs(p, x1, prev_x, d // hd, mesh)
    o, s1 = linear_attention_decode(
        *(t.reshape(b, -1, hd) for t in (r, k, v, logw)), s0, u=u)
    o = _gate(p, o.reshape(b, -1), g, x1.dtype, mesh)
    return out_project(p.wo, o, mesh), (x1, s1)


def rwkv_channel_mix_decode(p: RwkvParams, x1: torch.Tensor,
                            prev_x: torch.Tensor, mesh=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token channel mix: x1, prev_x [B, D] -> (out [B, D], x1)."""
    out, _ = rwkv_channel_mix(p, x1[:, None], prev_x, mesh)
    return out[:, 0], x1
