"""Decoder blocks: full-sequence apply (training's forward and the
prefill), one-token decode against a preallocated cache, and the cache
itself; the JAX package's ``repro.models.transformer`` for ``block ==
"attn"`` (attention + MLP), ``block == "moe"`` (attention + routed
experts, :mod:`.moe`, plus a dense MLP beside them with
``cfg.dense_residual``), ``block == "rwkv"`` (RWKV-6's token and channel
mixes, :mod:`.rwkv`: no attention) and ``block == "hymba"`` (attention and
SSM heads on the same normed input, averaged, :mod:`.ssm`, then an MLP).

The full-sequence attention is :func:`repro_torch.kernels.ops
.flash_attention` (K6 on the card, its plain version on the host), under
autograd where the weights are trainable.  The full-sequence block returns
the MoE's auxiliary loss beside its output, as the reference does
(``None`` for a block without experts, which launches nothing for it), and
what the prefill keeps: the keys and values, and RWKV's and Hymba's
recurrent states.  The decode step writes the new token's key and value
into the cache in place, at ``pos``, and the recurrent states likewise,
instead of returning an updated copy; an MoE block routes its one token
per row with ``S = 1`` (capacity 1, so every expert's weights are read).
Over a training mesh (``mesh``) the block is tensor-parallel over
``model`` and FSDP over ``data`` (:mod:`.attention`, :mod:`.mlp`; the
experts are expert-parallel over ``model``, :mod:`.moe`), and the decode
cache's sequence axis is split over ``seq_axis``: each rank attends over
its slice of the cache, the new key is written on the rank that owns
``pos``, and the partials are combined over that axis (flash-decoding).
RWKV's mixes and Hymba's SSM heads take the route of
:func:`repro_torch.models.linear_attn.linear_attention_route` over the
mesh (:mod:`.rwkv`, :mod:`.ssm`), and their recurrent states in the cache
are split over heads where the heads divide ``model``.

Whisper's encoder is a stack of ``"attn"`` blocks run non-causally
(:func:`block_attend` with ``causal=False``); its decoder's
:class:`CrossBlock` adds a cross-attention over the encoder's keys and
values between the causal self-attention and the MLP.  Both attentions
are K6, the cross-attention at ``Sq != Skv``; the decode step's
cross-attention is K6 at one query row over the ``xk``/``xv`` the prefill
cached.  Over a training mesh every attention of the encoder-decoder takes
:func:`repro_torch.models.attention.attention_route`'s route for its query
rows: the cross-attention's ``wq`` (over the decoder's stream) and
``wk``/``wv`` (over the encoder's output) are column-parallel over
``model`` and its ``wo`` row-parallel, as the self-attention's are; the
cache keeps ``xk``/``xv`` whole (all ``F`` frames, all KV heads), and the
decode step's cross-attention reads this rank's query heads' share of
them.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from .attention import (AttnParams, attend, combine_partials,
                        decode_partial, out_project, qkv_project,
                        query_project, whole_heads)
from .config import ModelConfig
from .layers import parameter, rms_norm
from .mlp import MlpParams, mlp_apply
from .moe import MoeParams, moe_route_apply
from .rwkv import (RwkvParams, rwkv_channel_mix, rwkv_channel_mix_decode,
                   rwkv_token_mix, rwkv_token_mix_decode)
from .ssm import SsmParams, ssm_apply, ssm_decode
from ..parallel.mesh import local_shape, mesh_axes
from .pspec import current_mesh


RECURRENT = ("rwkv", "hymba")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a model kind the port does not build."""
    why = None
    if cfg.block not in ("attn", "moe") + RECURRENT:
        why = f"block {cfg.block!r}"
    elif cfg.enc_dec and cfg.block != "attn":
        why = f"an encoder-decoder of {cfg.block!r} blocks"
    if why is not None:
        raise NotImplementedError(
            f"{cfg.name}: {why} not ported; the port builds decoders of "
            f"attention (dense or MoE, with RoPE or M-RoPE, from tokens or "
            f"embeddings), RWKV and Hymba blocks, and encoder-decoders of "
            f"attention blocks (Whisper), each on one device or over a "
            f"training mesh")


class Block(nn.Module):
    """One block: ``norm1``, ``norm2`` and, by ``cfg.block``: ``attn`` and
    ``mlp`` (``"attn"``); ``attn``, ``moe`` and, with
    ``cfg.dense_residual``, ``dense`` (an MLP beside the experts;
    ``"moe"``); ``rwkv`` (``"rwkv"``: its channel mix is its own, no
    ``mlp``); ``attn``, ``ssm`` and ``mlp`` (``"hymba"``).  Trainable
    weights take gradients."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 trainable: bool = False):
        super().__init__()
        check_supported(cfg)
        self.norm1 = parameter((cfg.d_model,), torch.float32, device,
                               trainable)
        self.norm2 = parameter((cfg.d_model,), torch.float32, device,
                               trainable)
        if cfg.block == "rwkv":
            self.rwkv = RwkvParams(cfg, device, trainable)
            return
        self.attn = AttnParams(cfg, device, trainable)
        if cfg.block == "moe":
            self.moe = MoeParams(cfg, device, trainable)
            if cfg.dense_residual:
                self.dense = MlpParams(cfg, device, trainable=trainable)
            return
        if cfg.block == "hymba":
            self.ssm = SsmParams(cfg, device, trainable)
        self.mlp = MlpParams(cfg, device, trainable=trainable)

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "Block":
        self.norm1.fill_(1.0)
        self.norm2.fill_(1.0)
        for name in ("rwkv", "attn", "ssm", "mlp", "moe", "dense"):
            if hasattr(self, name):
                getattr(self, name).init_(generator)
        return self


def block_init(generator: torch.Generator, cfg: ModelConfig) -> Block:
    return Block(cfg, generator.device).init_(generator)


class BlockOut(NamedTuple):
    """A full-sequence block's results: the stream ``x``, the block's keys
    and values ``[B, S, Hkv, hd]`` (over a mesh, this rank's KV heads
    where the heads route splits them; ``None`` for RWKV), the auxiliary
    loss (float32; ``None`` without experts), the routing the experts used
    (``[B, S, K]``; ``None`` without experts) and the recurrent state
    the decode continues from (RWKV: ``tm_x``/``cm_x`` [B, D], the last
    token of each mix's normed input, and ``wkv`` [B, H, hd, hd]; Hymba:
    ``ssm`` [B, H, N, hd]; ``None`` for attention blocks)."""
    x: torch.Tensor
    k: Optional[torch.Tensor]
    v: Optional[torch.Tensor]
    aux: Optional[torch.Tensor]
    eidx: Optional[torch.Tensor]
    state: Optional[Dict[str, torch.Tensor]] = None


def ffn_apply(p: Block, n2: torch.Tensor, cfg: ModelConfig, mesh=None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                         Optional[torch.Tensor]]:
    """The block's feed-forward of ``n2 [B, S, D]``: ``(out, aux, eidx)``,
    the experts (and the dense MLP beside them) or the MLP (``aux`` and
    ``eidx`` ``None``)."""
    if cfg.block != "moe":
        return mlp_apply(p.mlp, n2, cfg.mlp, mesh), None, None
    out, aux, eidx = moe_route_apply(p.moe, n2, cfg, mesh)
    if cfg.dense_residual:
        out = out + mlp_apply(p.dense, n2, cfg.mlp, mesh)
    return out, aux, eidx


def block_attend(p: Block, x: torch.Tensor, cfg: ModelConfig,
                 positions: Optional[torch.Tensor], causal: bool = True,
                 mesh=None) -> BlockOut:
    """Full-sequence block, with what the prefill and the routing monitor
    read beside the stream (:class:`BlockOut`)."""
    if cfg.block == "rwkv":
        n1 = rms_norm(x, p.norm1)
        h, (tm_x, wkv) = rwkv_token_mix(p.rwkv, n1, cfg, mesh=mesh)
        x = x + h
        h, cm_x = rwkv_channel_mix(p.rwkv, rms_norm(x, p.norm2), mesh=mesh)
        return BlockOut(x + h, None, None, None, None,
                        dict(tm_x=tm_x, cm_x=cm_x, wkv=wkv))
    n1 = rms_norm(x, p.norm1)
    q, k, v = qkv_project(p.attn, n1, cfg, positions, mesh)
    ao = attend(q, k, v, cfg.n_heads, cfg.n_kv_heads, causal, mesh,
                cfg.attn_chunk)
    b, s = ao.shape[:2]
    ao = out_project(p.attn.wo, ao.reshape(b, s, -1), mesh)
    state = None
    if cfg.block == "hymba":
        so, s1 = ssm_apply(p.ssm, n1, cfg, mesh=mesh)
        ao = (ao + so) * 0.5
        state = dict(ssm=s1)
    x = x + ao
    mo, aux, eidx = ffn_apply(p, rms_norm(x, p.norm2), cfg, mesh)
    return BlockOut(x + mo, k, v, aux, eidx, state)


def block_apply(p: Block, x: torch.Tensor, cfg: ModelConfig,
                positions: Optional[torch.Tensor],
                causal: bool = True, mesh=None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full-sequence block (training's forward and ``LM.forward``):
    ``(x, aux_loss)``, as the reference returns them (``aux_loss`` is
    ``None`` for a block without experts)."""
    out = block_attend(p, x, cfg, positions, causal, mesh)
    return out.x, out.aux


# ------------------------------------------------------- decode attention ---

def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, new_k: torch.Tensor,
                     new_v: torch.Tensor, pos: int,
                     dp_axes: Optional[tuple] = None,
                     seq_axis: Optional[str] = None, mesh=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention against the KV cache.

    q [B,Hq,hd]; cache_k/v [B,S,Hkv,hd]; new_k/v [B,Hkv,hd]; ``pos`` the
    position written.  The new key and value are written into the cache in
    place; returns ``(out [B,Hq,hd], cache_k, cache_v)``.  With
    ``seq_axis`` the cache is this rank's slice of the sequence, split
    over that axis of ``mesh`` (or the ambient mesh), and the softmax is
    combined over it.  ``dp_axes`` is the JAX signature's: the batch is
    already this rank's part."""
    b, s = cache_k.shape[:2]
    off, total = 0, s
    if seq_axis is not None:
        mesh = mesh if mesh is not None else current_mesh()
        off = mesh.coords[seq_axis] * s
        total = s * mesh.shape[seq_axis]
    if not 0 <= pos < total:
        raise ValueError(f"decode position {pos} outside the cache's "
                         f"{total}")
    if off <= pos < off + s:
        cache_k[:, pos - off] = new_k
        cache_v[:, pos - off] = new_v
    valid = (off + torch.arange(s, device=q.device) <= pos)[None].expand(b,
                                                                           s)
    part = decode_partial(q, cache_k, cache_v, valid)
    o = combine_partials(part, seq_axis, mesh)
    return o.to(q.dtype), cache_k, cache_v


def block_decode(p: Block, x1: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cfg: ModelConfig, pos: int,
                 positions: Optional[torch.Tensor], mesh=None,
                 seq_axis: Optional[str] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token block step.  x1 [B, D]; ``cache`` holds this layer's
    entries of :func:`init_cache` (``k``/``v`` [B, S, Hkv, hd], over a
    mesh this rank's slice of S along ``seq_axis``; RWKV's ``tm_x``,
    ``cm_x`` and ``wkv``; Hymba's ``ssm``), updated in place.  Returns
    (x1, cache)."""
    if cfg.block == "rwkv":
        h, (tm_x, wkv) = rwkv_token_mix_decode(
            p.rwkv, rms_norm(x1, p.norm1), cfg, (cache["tm_x"],
                                                 cache["wkv"]), mesh)
        cache["tm_x"].copy_(tm_x)
        cache["wkv"].copy_(wkv)
        x1 = x1 + h
        h, cm_x = rwkv_channel_mix_decode(p.rwkv, rms_norm(x1, p.norm2),
                                          cache["cm_x"], mesh)
        cache["cm_x"].copy_(cm_x)
        return x1 + h, cache
    n1 = rms_norm(x1, p.norm1)
    q, k, v = qkv_project(p.attn, n1[:, None], cfg, positions, mesh)
    q, k, v = (whole_heads(t[:, 0], n, mesh) for t, n in (
        (q, cfg.n_heads), (k, cfg.n_kv_heads), (v, cfg.n_kv_heads)))
    o, _, _ = decode_attention(q, cache["k"], cache["v"], k, v, pos,
                               seq_axis=seq_axis, mesh=mesh)
    ao = out_project(p.attn.wo, o.reshape(x1.shape[0], -1), mesh)
    if cfg.block == "hymba":
        so, s1 = ssm_decode(p.ssm, n1, cfg, cache["ssm"], mesh)
        cache["ssm"].copy_(s1)
        ao = (ao + so) * 0.5
    x1 = x1 + ao
    n2 = rms_norm(x1, p.norm2)
    return x1 + ffn_apply(p, n2[:, None], cfg, mesh)[0][:, 0], cache


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               device: torch.device, mesh=None) -> Dict[str, torch.Tensor]:
    """Zeroed decode cache, stacked over layers: ``k``/``v``
    [L, B, S, Hkv, hd] in the activation dtype for the attention blocks;
    Hymba's ``ssm`` [L, B, H, N, hd] float32 beside them; RWKV's ``tm_x``/
    ``cm_x`` [L, B, D] (activation dtype) and ``wkv`` [L, B, H, hd, hd]
    (float32), and no ``k``/``v``; an encoder-decoder's ``xk``/``xv``
    [L, B, enc_frames, Hkv, hd] (activation dtype), the encoder's keys
    and values for each decoder layer's cross-attention.  Over a mesh,
    this rank's block of it
    as ``cache_spec`` lays it out: S split over ``model``, the recurrent
    states' heads over ``model`` where they divide it (the ``"heads"``
    route of the mixes), B over the FSDP axes where they divide it;
    ``xk``/``xv`` keep every frame and every KV head."""
    check_supported(cfg)
    l, act, f32 = cfg.n_layers, cfg.act_dtype(), torch.float32
    if cfg.block == "rwkv":
        h, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        shapes = dict(tm_x=((l, batch, cfg.d_model), act),
                      cm_x=((l, batch, cfg.d_model), act),
                      wkv=((l, batch, h, hd, hd), f32))
    else:
        shape = (l, batch, seq, cfg.n_kv_heads, cfg.hd)
        shapes = dict(k=(shape, act), v=(shape, act))
        if cfg.block == "hymba":
            shapes["ssm"] = ((l, batch, cfg.ssm_heads, cfg.ssm_state,
                              cfg.hd), f32)
    if cfg.enc_dec:
        shape = (l, batch, cfg.enc_frames, cfg.n_kv_heads, cfg.hd)
        shapes.update(xk=(shape, act), xv=(shape, act))
    if mesh is not None:                # train.sharding.cache_spec's layout
        fsdp, tp = mesh_axes(mesh)
        b_ax = fsdp if batch % mesh.axis_size(fsdp) == 0 else None
        for name, (shape, dtype) in shapes.items():
            third = {"k": tp, "v": tp}.get(
                name, tp if name in ("wkv", "ssm")
                and shape[2] % mesh.shape[tp] == 0 else None)
            shapes[name] = (local_shape(shape, (None, b_ax, third), mesh),
                            dtype)
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in shapes.items()}


# ------------------------------------------------------ whisper enc/dec -----

class CrossBlock(Block):
    """A decoder block of the encoder-decoder: a :class:`Block`
    (``"attn"``: ``norm1``, ``attn``, ``norm2``, ``mlp``) plus ``norm_x``
    and ``xattn`` (an :class:`AttnParams`) for the cross-attention over
    the encoder's output."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 trainable: bool = False):
        super().__init__(cfg, device, trainable)
        self.norm_x = parameter((cfg.d_model,), torch.float32, device,
                                trainable)
        self.xattn = AttnParams(cfg, device, trainable)

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "CrossBlock":
        super().init_(generator)
        self.norm_x.fill_(1.0)
        self.xattn.init_(generator)
        return self


def _cross_attend(p: CrossBlock, x: torch.Tensor, enc_out: torch.Tensor,
                  cfg: ModelConfig, mesh=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(x + the cross-attention, xk, xv)``: the cross-attention of
    ``rms_norm(x, norm_x) @ wq`` (``x [B, S, D]``) over the keys and values
    ``enc_out @ wk``, ``enc_out @ wv`` (``enc_out [B, F, D]``), non-causal
    (K6 at ``Sq = S``, ``Skv = F``).  Over a mesh the projections are
    column-parallel and ``wo`` row-parallel, on the route of the ``S``
    query rows (:func:`repro_torch.models.attention.qkv_project`); ``xk``
    and ``xv`` are as the attention read them: this rank's KV heads where
    the heads route splits them, all of them otherwise."""
    b, s = x.shape[:2]
    nx = rms_norm(x, p.norm_x)
    qx, xk, xv = qkv_project(p.xattn, nx, cfg, None, mesh, kv_in=enc_out)
    xo = attend(qx, xk, xv, cfg.n_heads, cfg.n_kv_heads, False, mesh,
                cfg.attn_chunk)
    return x + out_project(p.xattn.wo, xo.reshape(b, s, -1), mesh), xk, xv


def cross_block_attend(p: CrossBlock, x: torch.Tensor,
                       enc_out: torch.Tensor, cfg: ModelConfig,
                       mesh=None) -> BlockOut:
    """Full-sequence decoder block: causal self-attention, the
    cross-attention over the encoder's output ``enc_out``, the MLP; with
    what the prefill keeps: the self-attention's keys and values, and the
    cross-attention's as ``state`` ``{"xk", "xv"}`` (over a mesh, in the
    layout each attention read them: :func:`_cross_attend`)."""
    n1 = rms_norm(x, p.norm1)
    q, k, v = qkv_project(p.attn, n1, cfg, None, mesh)
    ao = attend(q, k, v, cfg.n_heads, cfg.n_kv_heads, True, mesh,
                cfg.attn_chunk)
    b, s = ao.shape[:2]
    x = x + out_project(p.attn.wo, ao.reshape(b, s, -1), mesh)
    x, xk, xv = _cross_attend(p, x, enc_out, cfg, mesh)
    x = x + mlp_apply(p.mlp, rms_norm(x, p.norm2), cfg.mlp, mesh)
    return BlockOut(x, k, v, None, None, dict(xk=xk, xv=xv))


def cross_block_decode(p: CrossBlock, x1: torch.Tensor,
                       cache: Dict[str, torch.Tensor], cfg: ModelConfig,
                       pos: int, mesh=None, seq_axis: Optional[str] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decoder step.  ``x1 [B, D]``; ``cache`` holds this
    layer's ``k``/``v`` [B, S, Hkv, hd] (the new token's written at
    ``pos`` in place; over a mesh this rank's slice of S along
    ``seq_axis``, as :func:`block_decode` reads it) and ``xk``/``xv``
    [B, F, Hkv, hd], whole.  The cross-attention is K6 at one query row
    over all ``F`` encoder keys, non-causal: over a mesh on the route of
    one row, this rank's query heads over the KV heads they read where the
    heads divide ``model``, else every head on every rank.  Returns (x1,
    cache)."""
    b = x1.shape[0]
    n1 = rms_norm(x1, p.norm1)
    q, k, v = qkv_project(p.attn, n1[:, None], cfg, None, mesh)
    q, k, v = (whole_heads(t[:, 0], n, mesh) for t, n in (
        (q, cfg.n_heads), (k, cfg.n_kv_heads), (v, cfg.n_kv_heads)))
    o, _, _ = decode_attention(q, cache["k"], cache["v"], k, v, pos,
                               seq_axis=seq_axis, mesh=mesh)
    x1 = x1 + out_project(p.attn.wo, o.reshape(b, -1), mesh)
    y = x1[:, None]
    qx = query_project(p.xattn, rms_norm(y, p.norm_x), cfg, mesh)
    xo = attend(qx, cache["xk"], cache["xv"], cfg.n_heads, cfg.n_kv_heads,
                False, mesh, cfg.attn_chunk)
    x1 = (y + out_project(p.xattn.wo, xo.reshape(b, 1, -1), mesh))[:, 0]
    n2 = rms_norm(x1, p.norm2)
    return x1 + mlp_apply(p.mlp, n2[:, None], cfg.mlp, mesh)[:, 0], cache
