"""Routed mixture-of-experts with sort-based capacity dispatch; the JAX
package's ``repro.models.moe``.

The router is softmax-then-top-k with the load-balancing auxiliary loss of
Shazeer et al.  Within each batch row (a group), a token's assignments are
ranked within their expert by a stable sort of the flat expert ids and a
running position (``cummax`` of each run's start), so the first
``capacity`` tokens of each expert, in token order, are kept and the rest
dropped, as in the reference.  The expert feed-forwards are one batched
product over the expert axis on a ``[E, B*C, D]`` capacity buffer.

Where the reference scatters token rows into the buffer and scatter-adds
the gated expert rows back to token order, the port gathers both ways:
the buffer gathers each kept slot's token row, and each token gathers its
``top_k`` expert rows and sums them with its gates in one batched product
(float32 accumulation).  The backward of each gather is a gather through
the inverse map (a token's gradient sums its ``top_k`` slots' rows), so
no step scatters rows with atomics: forward and backward give the same
bits on every run on the card, and in float32 they equal the reference's
sums to their rounding order.

Two bodies, dispatched as the reference's ``moe_apply`` does:

* ``spmd`` (one device, or ``cfg.moe_impl == "spmd"``): routes in float32
  (``x.float() @ router.float()``).  Over a mesh the expert weights are
  gathered whole.
* ``ep`` (a mesh whose ``model`` axis divides ``n_experts``): every
  ``model`` rank routes all of its tokens (the activations are whole over
  ``model``) from bf16-rounded router weights with float32 accumulation,
  runs only its ``E / tp`` experts, and the partial outputs are summed
  over ``model``.  The dispatch input and the gates enter the experts
  through ``copy_to``, so their gradients, partial on each rank, are
  summed over ``model``.  The routing and the auxiliary loss are whole on
  every rank and enter the gradient once.

Over a mesh the auxiliary loss is the global one: the mean router
probabilities (``me``) and expert loads (``ce``) are averaged over the
FSDP axes; each rank's ``me`` enters with its share, so each data rank's
gradient reaches only its own tokens.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_reduce, copy_to, gather, reduce
from ..parallel.mesh import mesh_axes
from .config import ModelConfig
from .layers import dense_init, is_tp, parameter, weight


class MoeParams(nn.Module):
    """``router [D, E]`` (float32), ``wi``/``wg [E, D, F]`` and
    ``wo [E, F, D]`` in the param dtype (``wg`` for SwiGLU only);
    uninitialised until :meth:`init_`; trainable weights take
    gradients."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 trainable: bool = False):
        super().__init__()
        d, f, e, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.p_dtype()
        self.router = parameter((d, e), torch.float32, device, trainable)
        self.wi = parameter((e, d, f), dt, device, trainable)
        self.wo = parameter((e, f, d), dt, device, trainable)
        self.wg = parameter((e, d, f), dt, device, trainable) \
            if cfg.mlp == "swiglu" else None

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "MoeParams":
        """``moe_init``'s distributions: ``N(0, 1)`` scaled by ``D**-0.5``
        (``wi``, ``wg``, the router) and ``F**-0.5`` (``wo``), drawn in
        float32 one expert at a time."""
        e, d, f = self.wi.shape
        for i in range(e):
            self.wi[i].copy_(dense_init(generator, d, f, self.wi.dtype))
            self.wo[i].copy_(dense_init(generator, f, d, self.wo.dtype,
                                        scale=f ** -0.5))
            if self.wg is not None:
                self.wg[i].copy_(dense_init(generator, d, f, self.wg.dtype))
        self.router.copy_(dense_init(generator, d, e, torch.float32))
        return self


def moe_init(generator: torch.Generator, cfg: ModelConfig) -> MoeParams:
    return MoeParams(cfg, generator.device).init_(generator)


def _capacity(tokens_per_group: int, top_k: int, n_experts: int,
              factor: float) -> int:
    c = int(tokens_per_group * top_k * factor / n_experts)
    return max(c, 1)


def _uses_ep(cfg: ModelConfig, mesh) -> bool:
    return (cfg.moe_impl == "ep" and mesh is not None
            and "model" in mesh.axis_names
            and cfg.n_experts % mesh.shape["model"] == 0)


def moe_apply(p: MoeParams, x: torch.Tensor, cfg: ModelConfig, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux_loss float32 scalar): the
    ``ep`` body over a mesh whose ``model`` axis divides ``n_experts``
    (when ``cfg.moe_impl == "ep"``), the ``spmd`` body otherwise (module
    docstring)."""
    return moe_route_apply(p, x, cfg, mesh)[:2]


def moe_route_apply(p: MoeParams, x: torch.Tensor, cfg: ModelConfig,
                    mesh=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`moe_apply` and the routing it used: ``(out, aux, eidx)``,
    ``eidx`` [B, S, K] int64 expert ids, each token's in descending
    probability."""
    if _uses_ep(cfg, mesh):
        return _moe_apply_ep(p, x, cfg, mesh)
    return _moe_apply_spmd(p, x, cfg, mesh)


# ---------------------------------------------------------------- routing ---

def _route(x: torch.Tensor, router: torch.Tensor, top_k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(probs [B,S,E], gate [B,S,K], eidx [B,S,K])`` from float32
    logits ``x.float() @ router.float()``.  Top-k by a stable descending
    sort: ties go to the lower expert id, as ``jax.lax.top_k`` breaks
    them.  The gates are renormalised over the k."""
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = vals[..., :top_k], idx[..., :top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, eidx


def _aux_loss(probs: torch.Tensor, eidx: torch.Tensor, n_experts: int,
              mesh=None) -> torch.Tensor:
    """``n_experts * sum(me * ce)``: ``me`` the mean router probability
    of each expert, ``ce`` the share of assignments it got.  Over a mesh
    both are averaged over the FSDP axes (the global statistics); each
    rank's ``me`` enters with its share ``1 / n_data``, so the gradient
    each data rank takes reaches only its own tokens."""
    b, s, k = eidx.shape
    me = probs.mean(dim=(0, 1))
    counts = torch.bincount(eidx.reshape(-1), minlength=n_experts)
    ce = counts.float() / (b * s) / k
    if mesh is not None:
        fsdp, _ = mesh_axes(mesh)
        n = mesh.axis_size(fsdp)
        if n > 1:
            me, ce = me / n, ce / n
            for axis in fsdp:
                me = reduce(me, mesh.group(axis))
                ce = all_reduce(ce, mesh.group(axis))
    return (me * ce).sum() * n_experts


# ----------------------------------------------------- dispatch / experts ---

def _pad(t: torch.Tensor) -> torch.Tensor:
    """``t [N, D]`` with a zero row appended (row ``N``: the sentinel)."""
    return torch.cat([t, t.new_zeros(1, t.shape[1])])


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` with the sentinel ``idx == len(t)`` clamped onto the last
    row: no copy of ``t``, and the caller weights those rows by zero."""
    return t.index_select(0, idx.clamp(max=t.shape[0] - 1))


class _Gather(torch.autograd.Function):
    """``out[i] = table[idx[i]]``, where ``idx[i] == len(table)`` names the
    zero row, or, with ``weighted``, a row that the caller multiplies by a
    zero weight.  Its adjoint is a gather too: ``grad[j]`` is the sum of
    the ``per`` rows of ``grad_out`` that ``back[j * per:(j + 1) * per]``
    names (``len(idx)``: none).  ``back`` lists each row's uses, so neither
    direction scatters: no atomics, the same bits on every run.  The zero
    row is appended only to the token side (the dispatch's ``table``, the
    combine's ``grad_out``); the capacity buffer's side is never copied:
    the combine (``weighted``) clamps its sentinels and its gates zero
    them, and the dispatch's adjoint (``per > 1``) weights each use by 0
    or 1 in its sum."""

    @staticmethod
    def forward(ctx, table, idx, back, per, weighted):
        ctx.save_for_backward(back)
        ctx.n, ctx.per = table.shape[0], per
        if weighted:
            return _take(table, idx)
        return _pad(table).index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (back,) = ctx.saved_tensors
        n, per = ctx.n, ctx.per
        if per == 1:
            return _pad(g).index_select(0, back), None, None, None, None
        rows = _take(g, back).view(n, per, -1)
        live = (back < g.shape[0]).to(g.dtype).view(n, 1, per)
        return torch.matmul(live, rows)[:, 0], None, None, None, None


def _experts(x: torch.Tensor, gate: torch.Tensor, eidx: torch.Tensor,
             wi: torch.Tensor, wg: Optional[torch.Tensor], wo: torch.Tensor,
             capacity: int, lo: int) -> torch.Tensor:
    """The experts ``lo .. lo + E_local - 1`` (``wi``'s leading dim) applied
    to the tokens routed to them, gated and summed back to token order:
    ``[B, S, D]`` (zero rows for tokens none of these experts kept).

    Per batch row, the flat assignments are stably sorted by expert; an
    assignment's rank within its expert's run is its slot, kept when below
    ``capacity`` (the reference's ``_moe_local`` with ``lo``, and
    ``_moe_apply_spmd`` with ``lo = 0`` and every expert).  SwiGLU experts
    when ``wg`` is given, squared-ReLU ones otherwise.  The dispatch and
    the combine are gathers (:class:`_Gather`) through two maps, each the
    other's inverse: slot -> assignment and assignment -> slot."""
    b, s, d = x.shape
    k = eidx.shape[-1]
    epl, c = wi.shape[0], capacity
    a = s * k
    dev = x.device
    flat_e = eidx.reshape(b, a)
    order = torch.argsort(flat_e, dim=1, stable=True)
    e_sorted = flat_e.gather(1, order)
    ar = torch.arange(a, device=dev)
    change = torch.ones_like(e_sorted, dtype=torch.bool)
    change[:, 1:] = e_sorted[:, 1:] != e_sorted[:, :-1]
    run_start = torch.cummax(torch.where(change, ar, 0), dim=1).values
    pos = ar - run_start                          # rank within the expert
    keep = (pos < c) & (e_sorted >= lo) & (e_sorted < lo + epl)
    rows = epl * b * c                            # the buffer [E_l, B, C]
    bidx = torch.arange(b, device=dev)[:, None]
    slot = torch.where(keep, ((e_sorted - lo) * b + bidx) * c + pos, rows)
    # assignment (b, t, j) -> its slot, in token order (b * a: the flat
    # index (b * S + t) * K + j); slot -> its assignment (b * a: empty)
    slot_tok = torch.empty_like(slot).scatter_(1, order, slot).reshape(-1)
    asg = torch.full((rows + 1,), b * a, dtype=torch.long, device=dev)
    asg.scatter_(0, slot.reshape(-1), (bidx * a + order).reshape(-1))
    asg = asg[:rows]
    src = torch.where(asg < b * a, asg // k, b * s)   # slot -> token row

    # dispatch: each slot gathers its token's row
    buf = _Gather.apply(x.reshape(b * s, d), src, slot_tok, k, False
                        ).reshape(epl, b * c, d)

    # the expert feed-forwards, batched over the expert axis
    dt = x.dtype
    h = torch.bmm(buf, wi.to(dt))
    if wg is not None:
        g2 = torch.bmm(buf, wg.to(dt))
        h = F.silu(g2.float()).to(dt) * h
        del g2
    else:
        h = torch.square(F.relu(h.float())).to(dt)
    del buf
    eo = torch.bmm(h, wo.to(dt))
    del h

    # combine: each token gathers its k expert rows and sums them with its
    # gates, zero where the assignment was dropped or is not local
    back = _Gather.apply(eo.reshape(rows, d), slot_tok, asg, 1, True
                         ).reshape(b, s, k, d)
    keep_tok = (slot_tok < rows).reshape(b, s, k)
    w = (gate * keep_tok).to(dt)
    return torch.matmul(w[:, :, None, :], back)[:, :, 0]


def _moe_apply_spmd(p: MoeParams, x: torch.Tensor, cfg: ModelConfig,
                    mesh=None):
    """The reference's GSPMD body: float32 routing, every expert.  Over a
    mesh each rank applies it to its rows with the weights whole (gathered
    over FSDP, and over ``model`` where that splits the experts) and the
    global auxiliary loss."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = _capacity(s, k, e, cfg.capacity_factor)
    probs, gate, eidx = _route(x, weight(p.router, mesh), k)
    aux = _aux_loss(probs, eidx, e, mesh)

    def whole(param):
        w = weight(param, mesh)
        if mesh is not None and is_tp(param) and mesh.shape["model"] > 1:
            w = gather(w, 0, mesh.group("model"), "split")
        return w

    wg = None if p.wg is None else whole(p.wg)
    out = _experts(x, gate, eidx, whole(p.wi), wg, whole(p.wo), c, 0)
    return out, aux, eidx


def _moe_apply_ep(p: MoeParams, x: torch.Tensor, cfg: ModelConfig, mesh):
    """Expert parallelism over ``model`` (module docstring): all tokens
    routed on every rank, this rank's ``E / tp`` experts applied, the
    partial outputs summed over ``model``."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    tp = mesh.shape["model"]
    grp = mesh.group("model") if tp > 1 else None
    c = _capacity(s, k, e, cfg.capacity_factor)
    router = weight(p.router, mesh)
    probs, gate, eidx = _route(x, router.to(x.dtype), k)
    aux = _aux_loss(probs, eidx, e, mesh)
    wi = weight(p.wi, mesh)
    lo = mesh.coords["model"] * wi.shape[0] if tp > 1 else 0
    wg = None if p.wg is None else weight(p.wg, mesh)
    out = _experts(copy_to(x, grp), copy_to(gate, grp), eidx, wi, wg,
                   weight(p.wo, mesh), c, lo)
    return reduce(out, grp), aux, eidx
