"""GQA attention: projections, the attention over a sequence (sharded
over a training mesh) and partial-softmax decode; the JAX package's
``repro.models.attention``.

* The attention over a whole sequence (training's forward and the
  prefill) is the flash kernel (:func:`repro_torch.kernels.ops
  .flash_attention`, K6 on the card, differentiable), in place of the JAX
  package's ``block_attention``; its plain version, chunked over query
  rows with GQA by grouping, is
  :func:`repro_torch.kernels.attention.flash_attention_plain`, and its
  backward recomputes the scores chunk by chunk, as ``block_attention``'s
  rematerialised query blocks do.  :func:`block_attention` is the JAX
  package's scan over query blocks in plain torch (padded keys
  ``kv_valid`` and the query offset ``q_offset`` included): the reference
  the kernel is held to.
* Over a training mesh (:class:`repro_torch.parallel.mesh.Mesh`) the
  projections are column-parallel over ``model`` and the route follows
  :func:`attention_route`, the JAX package's ``sharded_attention``
  decision: K6 on this rank's query heads when ``Hq % tp == 0``; else, when
  ``Sq % tp == 0``, the sequence-parallel route (this rank's ``Sq / tp``
  query rows against the whole K/V, K6 with ``q_offset``, the rows
  gathered back over ``model``); else every rank computes it all.
* Decode computes partial softmax statistics (max, sum-exp, unnormalised
  output); :func:`combine_partials` combines them, across a cache whose
  sequence axis is split over a mesh axis with a max and two sums there.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..kernels import ops
from ..parallel.collectives import all_reduce, copy_to, gather, reduce, split
from .config import ModelConfig
from .layers import (apply_mrope, apply_rope, dense_init, is_tp, parameter,
                     weight)
from .pspec import current_mesh


class AttnParams(nn.Module):
    """``wq [D, Hq*hd]``, ``wk``/``wv [D, Hkv*hd]``, ``wo [Hq*hd, D]`` and,
    with ``qkv_bias``, ``bq``/``bk``/``bv`` (uninitialised until
    :meth:`init_`); trainable weights take gradients."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 trainable: bool = False):
        super().__init__()
        d, hq, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        dt = cfg.p_dtype()
        self.wq = parameter((d, hq * hd), dt, device, trainable)
        self.wk = parameter((d, hk * hd), dt, device, trainable)
        self.wv = parameter((d, hk * hd), dt, device, trainable)
        self.wo = parameter((hq * hd, d), dt, device, trainable)
        for name, width in (("bq", hq * hd), ("bk", hk * hd),
                            ("bv", hk * hd)):
            setattr(self, name, parameter((width,), dt, device, trainable)
                    if cfg.qkv_bias else None)

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "AttnParams":
        for w in (self.wq, self.wk, self.wv):
            w.copy_(dense_init(generator, *w.shape, w.dtype))
        d_in = self.wo.shape[0]
        self.wo.copy_(dense_init(generator, *self.wo.shape, self.wo.dtype,
                                 scale=d_in ** -0.5))
        for b in (self.bq, self.bk, self.bv):
            if b is not None:
                b.zero_()
        return self


def attn_init(generator: torch.Generator, cfg: ModelConfig) -> AttnParams:
    return AttnParams(cfg, generator.device).init_(generator)


def attention_route(n_heads: int, sq: int, tp: int) -> str:
    """The route of the attention over ``sq`` query rows on a ``model``
    axis of ``tp`` ranks: ``"heads"`` (each rank its ``n_heads / tp``
    query heads), ``"sequence"`` (each rank its ``sq / tp`` query rows) or
    ``"replicated"`` (every rank all of it); JAX's ``sharded_attention``
    decision."""
    if tp == 1 or n_heads % tp == 0:
        return "heads"
    if sq % tp == 0:
        return "sequence"
    return "replicated"


def _tp(mesh) -> int:
    return 1 if mesh is None else mesh.shape.get("model", 1)


def qkv_project(p: AttnParams, x: torch.Tensor, cfg: ModelConfig,
                positions: Optional[torch.Tensor], mesh=None,
                kv_in: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x [B, S, D]`` -> q ``[B, S, Hq, hd]``, k, v ``[B, S, Hkv, hd]``,
    with RoPE (``positions [B, S]``) or M-RoPE (``[3, B, S]``) on q and
    k.  With ``kv_in [B, Skv, D]`` (a cross-attention's other sequence)
    k and v are its projections, ``[B, Skv, Hkv, hd]``.

    Over a mesh the weights are gathered over the FSDP axes and the
    products whose weight ``model`` splits are column-parallel.  Then q
    holds this rank's query heads on the ``"heads"`` route (of the ``S``
    query rows) and all of them on the others; k and v hold this rank's
    KV heads where the heads route splits them exactly (``Hkv % tp ==
    0``), all of them otherwise (gathered over ``model``; their gradient
    summed there when the ranks use them apart)."""
    b, s, _ = x.shape
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    tp = _tp(mesh)
    grp = mesh.group("model") if tp > 1 else None
    xs = copy_to(x, grp) if tp > 1 else x
    kin = x if kv_in is None else kv_in
    ks = xs if kv_in is None or tp == 1 else copy_to(kv_in, grp)

    def proj(w, bias, inp, inp_s):
        sharded = tp > 1 and is_tp(w)
        y = (inp_s if sharded else inp) @ weight(w, mesh, x.dtype)
        if bias is not None:
            y = y + weight(bias, mesh, x.dtype)
        return y, sharded

    (q, q_sh), (k, k_sh), (v, v_sh) = (proj(p.wq, p.bq, x, xs),
                                       proj(p.wk, p.bk, kin, ks),
                                       proj(p.wv, p.bv, kin, ks))
    if tp > 1:
        route = attention_route(hq, s, tp)
        shared = route != "replicated"     # the ranks use k, v apart
        if route != "heads" and q_sh:
            q = gather(q, 2, grp, "split")

        def whole(t, sharded):
            if route == "heads" and sharded and hk % tp == 0:
                return t                   # exactly this rank's KV heads
            if sharded:
                return gather(t, 2, grp, "sum" if shared else "split")
            return copy_to(t, grp) if shared else t

        k, v = whole(k, k_sh), whole(v, v_sh)
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, kin.shape[1], -1, hd)
    v = v.reshape(b, kin.shape[1], -1, hd)
    if positions is not None and cfg.rope in ("rope", "mrope"):
        rope = apply_rope if cfg.rope == "rope" else apply_mrope
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def query_project(p: AttnParams, x: torch.Tensor, cfg: ModelConfig,
                  mesh=None) -> torch.Tensor:
    """``x [B, S, D]`` -> q ``[B, S, Hq, hd]`` alone (no rotary: the
    cross-attention's query over keys and values cached whole), laid out
    as :func:`qkv_project` lays it out: over a mesh this rank's query
    heads on the ``"heads"`` route, all of them on the others."""
    b, s, _ = x.shape
    tp = _tp(mesh)
    grp = mesh.group("model") if tp > 1 else None
    sharded = tp > 1 and is_tp(p.wq)
    q = (copy_to(x, grp) if sharded else x) @ weight(p.wq, mesh, x.dtype)
    if p.bq is not None:
        q = q + weight(p.bq, mesh, x.dtype)
    if sharded and attention_route(cfg.n_heads, s, tp) != "heads":
        q = gather(q, 2, grp, "split")
    return q.reshape(b, s, -1, cfg.hd)


def _pick_chunk(s: int, want: int) -> int:
    """Largest divisor of ``s`` that is <= want (prefer the configured
    block)."""
    want = min(want, s)
    if s % want == 0:
        return want
    for c in range(want, 0, -1):
        if s % c == 0:
            return c
    return s


def block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, chunk: int,
                    kv_valid: Optional[torch.Tensor] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q [B,Sq,Hq,hd] x k,v [B,Skv,Hkv,hd] -> [B,Sq,Hq,hd], the JAX
    package's ``block_attention`` in plain torch: query blocks of the
    largest divisor of ``Sq`` up to ``chunk``, float32 logits, masked
    logits ``-1e30``, the probabilities in ``v``'s dtype times ``v`` in
    float32, the output in ``q``'s dtype.  ``kv_valid`` [B, Skv] masks
    padded keys; ``q_offset`` is the global position of q row 0 (a
    sequence-parallel shard passes its offset, so the causal mask stays
    global)."""
    b, sq, hq, hd = q.shape
    skv, hk = k.shape[1], k.shape[2]
    g = hq // hk
    c = _pick_chunk(sq, chunk)
    kf, vf = k.float(), v.float()
    kv_pos = torch.arange(skv, device=q.device)
    outs = []
    for s0 in range(0, sq, c):
        qi = q[:, s0:s0 + c].float().reshape(b, c, hk, g, hd)
        logits = torch.einsum("bchgd,bshd->bchgs", qi, kf) * hd ** -0.5
        mask = None
        if causal:
            q_pos = q_offset + s0 + torch.arange(c, device=q.device)
            mask = (q_pos[:, None] >= kv_pos[None, :])[None, :, None,
                                                       None, :]
        if kv_valid is not None:
            kvm = kv_valid[:, None, None, None, :]
            mask = kvm if mask is None else (mask & kvm)
        if mask is not None:
            logits = torch.where(mask, logits, torch.full_like(logits,
                                                               -1e30))
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bchgs,bshd->bchgd", w.to(v.dtype).float(), vf)
        outs.append(out.to(q.dtype).reshape(b, c, hq, hd))
    return torch.cat(outs, dim=1)


def _attention(q, k, v, causal: bool, chunk: int, kv_valid, q_offset: int):
    """K6 (its plain version on the host); the plain scan where keys are
    padded, which the kernel does not take."""
    if kv_valid is None:
        return ops.flash_attention(q, k, v, causal, q_offset=q_offset)
    return block_attention(q, k, v, causal, chunk, kv_valid, q_offset)


def _kv_for_heads(t: torch.Tensor, n_heads: int, mesh) -> torch.Tensor:
    """Of all ``Hkv`` KV heads, those this rank's query heads read (the
    ``"heads"`` route), grouped as K6 reads them: a slice when its query
    heads fall evenly on them, else one KV head per query head."""
    tp, r = mesh.shape["model"], mesh.coords["model"]
    hq_l, g = n_heads // tp, n_heads // t.shape[2]
    heads = [(r * hq_l + i) // g for i in range(hq_l)]   # consecutive
    n_kv = len(set(heads))
    if all(heads.count(h) * n_kv == hq_l for h in heads):
        return t.narrow(2, heads[0], n_kv).contiguous()
    return t.index_select(2, torch.tensor(heads, device=t.device))


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           n_heads: int, n_kv_heads: int, causal: bool, mesh=None,
           chunk: int = 512, kv_valid: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """The attention over :func:`qkv_project`'s q, k, v: on the ``"heads"``
    route this rank's query heads (out ``[B, S, Hq / tp, hd]``), on the
    others all of them."""
    tp = _tp(mesh)
    if tp == 1:
        return _attention(q, k, v, causal, chunk, kv_valid, 0)
    grp = mesh.group("model")
    route = attention_route(n_heads, q.shape[1], tp)
    if route == "heads":
        if k.shape[2] == n_kv_heads:          # all KV heads: this rank's
            k, v = (_kv_for_heads(t, n_heads, mesh) for t in (k, v))
        return _attention(q, k, v, causal, chunk, kv_valid, 0)
    if route == "sequence":
        s_local = q.shape[1] // tp
        o = _attention(split(q, 1, grp), k, v, causal, min(chunk, s_local),
                       kv_valid, mesh.coords["model"] * s_local)
        return gather(o, 1, grp, "split")
    return _attention(q, k, v, causal, chunk, kv_valid, 0)


def sharded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, chunk: int = 512,
                      kv_valid: Optional[torch.Tensor] = None,
                      mesh=None) -> torch.Tensor:
    """Attention with automatic sequence parallelism over ``model``; q, k,
    v and the output whole on every rank of ``model`` (the batch is this
    rank's part), under ``mesh`` or the ambient mesh.

    When the query-head count divides the TP axis each rank computes its
    query heads (K6) and the heads are gathered back.  Otherwise, when
    ``Sq`` divides it, each rank computes all heads for its ``Sq / tp``
    query rows against the whole K/V, with the causal mask offset to
    global positions (K6's ``q_offset``), and the rows are gathered back.
    Otherwise every rank computes it all.  Without a mesh this is the
    attention on one device."""
    mesh = mesh if mesh is not None else current_mesh()
    tp = _tp(mesh if mesh is not None and mesh.groups else None)
    if tp == 1:
        return _attention(q, k, v, causal, chunk, kv_valid, 0)
    grp = mesh.group("model")
    route = attention_route(q.shape[2], q.shape[1], tp)
    if route == "replicated":
        return _attention(q, k, v, causal, chunk, kv_valid, 0)
    k, v = copy_to(k, grp), copy_to(v, grp)   # the ranks use them apart
    if route == "sequence":
        return attend(q, k, v, q.shape[2], k.shape[2], causal, mesh, chunk,
                      kv_valid)
    o = attend(split(q, 2, grp), k, v, q.shape[2], k.shape[2], causal, mesh,
               chunk, kv_valid)
    return gather(o, 2, grp, "split")


def whole_heads(t: torch.Tensor, n: int, mesh) -> torch.Tensor:
    """``t [..., H_local, hd]`` with all ``n`` heads: gathered over
    ``model`` where this rank holds a part (no gradient: decode)."""
    if t.shape[-2] == n or _tp(mesh) == 1:
        return t
    return gather(t, t.dim() - 2, mesh.group("model"), "split")


def out_project(wo: torch.Tensor, ao: torch.Tensor, mesh=None
                ) -> torch.Tensor:
    """``ao [..., H * hd]`` @ ``wo``: row-parallel over ``model`` where
    ``model`` splits ``wo`` (this rank's columns of ``ao``, the partial
    products summed over ``model``)."""
    w = weight(wo, mesh, ao.dtype)
    if _tp(mesh) == 1 or not is_tp(wo):
        return ao @ w
    grp = mesh.group("model")
    if ao.shape[-1] != w.shape[0]:            # all heads: take this rank's
        ao = split(ao, ao.dim() - 1, grp)
    return reduce(ao @ w, grp)


class DecodePartial(NamedTuple):
    """Unnormalised partial attention over a KV shard (flash-decoding)."""
    o: torch.Tensor            # [B, Hq, hd]  sum softmax-unnorm * V
    m: torch.Tensor            # [B, Hq]      running max logit
    l: torch.Tensor            # [B, Hq]      sum exp(logit - m)


def decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_valid: torch.Tensor) -> DecodePartial:
    """q [B,Hq,hd]; k,v [B,S_shard,Hkv,hd]; kv_valid [B,S_shard] bool."""
    b, hq, hd = q.shape
    hk = k.shape[2]
    g = hq // hk
    qf = q.reshape(b, hk, g, hd).float()
    logits = torch.einsum("bhgd,bshd->bhgs", qf, k.float()) * hd ** -0.5
    logits = logits.masked_fill(~kv_valid[:, None, None, :], -1e30)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    # guard fully-masked shards (m = -1e30): zero their weight
    dead = m <= -1e29
    p = p.masked_fill(dead[..., None], 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return DecodePartial(o=o.reshape(b, hq, hd),
                         m=m.masked_fill(dead, float("-inf")).reshape(b, hq),
                         l=l.reshape(b, hq))


def combine_partials(parts: DecodePartial, axis_name: Optional[str] = None,
                     mesh=None) -> torch.Tensor:
    """Combine partial softmax stats.  With ``axis_name`` the partials are
    over the shards of a cache split along that axis of ``mesh`` (or the
    ambient mesh): the maxima are combined with a max and the rescaled
    sums with a sum over its group (JAX's ``pmax`` and ``psum``);
    otherwise the partials are already total."""
    o, m, l = parts
    if axis_name is None:
        return (o / l.clamp_min(1e-30)[..., None]).to(o.dtype)
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError(f"combine_partials over {axis_name!r}: no mesh")
    grp = mesh.group(axis_name)
    gm = all_reduce(m, grp, "max")
    gm_safe = torch.where(torch.isinf(gm), torch.zeros_like(gm), gm)
    m_safe = torch.where(torch.isinf(m), gm_safe - 80.0, m)
    corr = torch.exp(m_safe - gm_safe)
    o_sum = all_reduce(o * corr[..., None], grp)
    l_sum = all_reduce(l * corr, grp)
    return o_sum / l_sum.clamp_min(1e-30)[..., None]
