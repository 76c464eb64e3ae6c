"""Chunked linear attention with data-dependent decay; the JAX package's
``repro.models.linear_attn``.

Shared sequence-mixing core for RWKV-6 (vector decay per key channel) and
Hymba's SSD-style heads (scalar decay per head, broadcast to the key
channels).  Recurrence per head:

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)      (u = 0 for SSD heads)

Chunk algorithm (every exponent is <= 0: the cumulative log-decay ``P`` is
non-increasing):

    inter:  o_t += (r_t  exp(P_{t-1})) . S_0
    intra:  A[t,i] = sum_d r_t[d] k_i[d] exp(P_{t-1,d} - P_{i,d}),  i < t
    state:  S' = diag(exp(P_last)) S_0 + sum_i (k_i exp(P_last - P_i)) v_i^T

Pass 1 (every chunk at once) gives each chunk's local state and total
decay; the combine, a Python loop over the ``n`` chunk states, gives the
state before each chunk; pass 2 gives each chunk's outputs.  Pass 2's
pairwise tensors are ``[c, c, dk]`` float32 a chunk, batch and head, so
it runs over groups of chunks sized to keep one such tensor near
``GROUP_BYTES`` (the reference maps it over every chunk at once); the
grouping changes no chunk's arithmetic.  Under autograd each group runs
under ``torch.utils.checkpoint``, as the reference wraps its chunk in
``jax.checkpoint``: the backward recomputes the pairwise tensors.  The
masked pairs (``i >= t``) are exponentiated from ``-inf``, so they are 0
and carry no gradient, where the reference selects 0 after the
exponential.  Decode is the O(1) recurrence update.

Over a training mesh (its ``model`` axis of ``tp`` ranks) the mixes take
one route a call, :func:`linear_attention_route`, as
:func:`repro_torch.models.attention.attention_route` decides the
attention's: ``"heads"`` when the heads divide ``tp`` (each rank runs the
core on its heads, no collective here); ``"chunks"``, the reference's
``_chunk_mesh`` route, when the ``n`` chunks divide ``tp`` (the inputs
whole on every rank: each rank runs pass 1 and pass 2 on its ``n / tp``
chunks, the chunk states and decays are gathered over ``model`` in one
collective, every rank runs the same combine, and the outputs are
gathered back along the chunks); ``"replicated"`` otherwise (every rank
all of it).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.collectives import copy_to, gather, split

# pass 2's group of chunks keeps one [g, B, H, c, c, dk] float32 tensor
# near this size (a few such tensors are live at once)
GROUP_BYTES = 1 << 30


def chunk_len(chunk: int, s: int) -> int:
    """The reference's chunk length for ``s`` tokens: the largest length
    up to ``chunk`` that divides ``s`` (1 for a prime ``s`` above
    ``chunk``)."""
    c = min(chunk, s)
    while s % c:
        c -= 1
    return c


def linear_attention_route(n_heads: int, s: int, tp: int,
                           chunk: int = 64) -> str:
    """The route of a mix over ``s`` tokens in ``n_heads`` heads on a
    ``model`` axis of ``tp`` ranks: ``"heads"``, ``"chunks"`` or
    ``"replicated"`` (module docstring).  ``"chunks"`` needs the chunk
    count ``n = s / chunk_len(chunk, s)`` to divide ``tp``: at ``s`` 128
    there are 2 chunks of 64, too few for 4 ranks."""
    if tp == 1 or n_heads % tp == 0:
        return "heads"
    if (s // chunk_len(chunk, s)) % tp == 0:
        return "chunks"
    return "replicated"


def _chunk_out(rr, kk, vv, lw, s0, uu, mask):
    """Pass 2 on a group of chunks ``[g, B, H, c, d*]``: the inter-chunk
    output from the state before each chunk ``s0 [g, B, H, dk, dv]``, the
    intra-chunk pairs and the current-token bonus ``uu [H, dk]``."""
    p = torch.cumsum(lw, dim=3)
    pprev = p - lw
    o_inter = torch.einsum("nbhtd,nbhdv->nbhtv", rr * torch.exp(pprev), s0)
    m = (pprev.unsqueeze(4) - p.unsqueeze(3)).masked_fill_(
        ~mask, float("-inf")).exp_()                     # [g,b,h,t,i,dk]
    a = torch.einsum("nbhtd,nbhid,nbhtid->nbhti", rr, kk, m)
    o_intra = torch.einsum("nbhti,nbhiv->nbhtv", a, vv)
    if uu is not None:                                   # current token
        cur = torch.einsum("nbhtd,hd,nbhtd->nbht", rr, uu, kk)
        o_intra = o_intra + cur[..., None] * vv
    return o_inter + o_intra


def chunked_linear_attention(r: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, logw: torch.Tensor,
                             u: Optional[torch.Tensor] = None,
                             chunk: int = 64,
                             state0: Optional[torch.Tensor] = None,
                             mesh=None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, logw: [B, S, H, dk]; v: [B, S, H, dv]; u: [H, dk] or None;
    state0: [B, H, dk, dv] or None (zeros).

    Returns ``(o [B, S, H, dv]`` in ``r``'s dtype, ``final_state [B, H,
    dk, dv]`` float32); everything inside is float32 (module docstring).
    With ``mesh`` this is the ``"chunks"`` route over its ``model`` axis
    (the chunk count must divide it): the inputs, the output and the
    final state are whole on every rank, each input's gradient is every
    rank's whole (each rank's chunks are a ``split``, whose backward
    gathers), and the final state takes no gradient."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    c = chunk_len(chunk, s)
    n = s // c
    out_dtype = r.dtype
    grp, n_own, first = None, n, 0
    if mesh is not None and mesh.shape["model"] > 1:
        tp, grp = mesh.shape["model"], mesh.group("model")
        if n % tp:
            raise ValueError(f"{n} chunks of {c} do not split over {tp} "
                             f"ranks: take the heads or replicated route")
        # this rank's chunks are its n / tp consecutive runs of c tokens,
        # the four inputs cut in one split (one gather in the backward)
        n_own, first = n // tp, mesh.coords["model"] * (n // tp)
        r, k, v, logw = split(torch.cat(
            [t.float() for t in (r, k, v, logw)], dim=-1), 1, grp).split(
                [dk, dk, dv, dk], dim=-1)

    def chunks(t, d):                                    # [n, b, h, c, d]
        return t.float().reshape(b, n_own, c, h, d).permute(1, 0, 3, 2, 4)

    rr, kk, lw = (chunks(t, dk) for t in (r, k, logw))
    vv = chunks(v, dv)
    state = (torch.zeros((b, h, dk, dv), dtype=torch.float32,
                         device=r.device) if state0 is None
             else state0.float())
    uu = None if u is None else u.float()
    if grp is not None:
        # every rank's chunks read u and the starting state: their
        # gradients are the sum of the ranks'
        state = state if state0 is None else copy_to(state, grp)
        uu = None if uu is None else copy_to(uu, grp)

    # pass 1: each chunk's local state and total decay
    p = torch.cumsum(lw, dim=3)
    plast = p[:, :, :, -1:, :]
    s_loc = torch.einsum("nbhtd,nbhtv->nbhdv", kk * torch.exp(plast - p),
                         vv)
    decay = torch.exp(plast.squeeze(3))                  # [n, b, h, dk]
    del p, plast
    if grp is not None:
        # every chunk's state and decay on every rank, in one gather; each
        # rank's pass 2 reads its own chunks' starting states, so the
        # ranks' gradients of them are summed
        both = gather(torch.cat([s_loc, decay[..., None]], dim=-1), 0, grp,
                      "sum")
        s_loc, decay = both[..., :dv], both[..., dv]

    # combine: the state before each chunk, and the final state
    before = []
    for i in range(n):
        before.append(state)
        state = state * decay[i][..., None] + s_loc[i]
    # (sliced after the stack: every rank's graph then reaches the gather,
    # rank 0's too, whose own chunks start from state0, so that every rank
    # runs the gather's backward collective)
    s0s = torch.stack(before)[first:first + n_own]

    # pass 2 over groups of chunks
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                      diagonal=-1)[:, :, None]
    g = max(1, GROUP_BYTES // (b * h * c * c * dk * 4))
    remat = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (r, k, v, logw, u, state0))
    outs = []
    for i in range(0, n_own, g):
        args = (rr[i:i + g], kk[i:i + g], vv[i:i + g], lw[i:i + g],
                s0s[i:i + g], uu, mask)
        outs.append(checkpoint(_chunk_out, *args, use_reentrant=False)
                    if remat else _chunk_out(*args))
    o = torch.cat(outs) if len(outs) > 1 else outs[0]
    o = o.permute(1, 0, 3, 2, 4).reshape(b, n_own * c, h, dv).to(out_dtype)
    if grp is not None:       # every rank reads the whole output alike
        # (the final state, which the decode continues from, takes no
        # gradient here: the gather above sums the ranks' gradients)
        return gather(o, 1, grp, "split"), state.detach()
    return o, state


def linear_attention_decode(r: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, logw: torch.Tensor,
                            state: torch.Tensor,
                            u: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token update.  r, k, logw [B, H, dk]; v [B, H, dv]; state
    [B, H, dk, dv] float32.  Returns ``(o [B, H, dv]`` in ``r``'s dtype,
    the new state)``."""
    rf, kf, vf = (t.float() for t in (r, k, v))
    w = torch.exp(logw.float())
    kv = kf[..., :, None] * vf[..., None, :]             # [B, H, dk, dv]
    eff = state if u is None else state + u.float()[None, :, :, None] * kv
    o = torch.einsum("bhd,bhdv->bhv", rf, eff)
    return o.to(r.dtype), state * w[..., None] + kv
