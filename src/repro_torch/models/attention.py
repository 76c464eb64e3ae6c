"""GQA attention: projections and partial-softmax decode; the JAX
package's ``repro.models.attention`` on one device.

* The attention over a whole sequence (training's forward and the
  prefill) is the flash kernel (:func:`repro_torch.kernels.ops
  .flash_attention`, K6 on the card, differentiable), in place of the JAX
  package's ``block_attention``; its plain version, chunked over query
  rows with GQA by grouping, is
  :func:`repro_torch.kernels.attention.flash_attention_plain`, and its
  backward recomputes the scores chunk by chunk, as ``block_attention``'s
  rematerialised query blocks do.
* Decode computes partial softmax statistics (max, sum-exp, unnormalised
  output) and combines them.  Combining across a sequence-sharded cache
  (``axis_name``) and the sequence-parallel ``sharded_attention`` wait for
  the sharding slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from .config import ModelConfig
from .layers import apply_rope, dense_init, parameter


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


def qkv_project(p: AttnParams, x: torch.Tensor, cfg: ModelConfig,
                positions: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x [B, S, D]`` -> q ``[B, S, Hq, hd]``, k, v ``[B, S, Hkv, hd]``,
    with RoPE on q and k."""
    b, s, _ = x.shape
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p.wq.to(x.dtype)
    k = x @ p.wk.to(x.dtype)
    v = x @ p.wv.to(x.dtype)
    if p.bq is not None:
        q, k, v = (q + p.bq.to(x.dtype), k + p.bk.to(x.dtype),
                   v + p.bv.to(x.dtype))
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hk, hd)
    v = v.reshape(b, s, hk, hd)
    if cfg.rope == "mrope":
        raise NotImplementedError("M-RoPE is not ported yet "
                                  "(ROADMAP item 14)")
    if cfg.rope == "rope" and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


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


def combine_partials(parts: DecodePartial,
                     axis_name: Optional[str] = None) -> torch.Tensor:
    """Normalise partial softmax stats that are already total; combining
    across mesh shards (``axis_name``) waits for the sharding slice."""
    if axis_name is not None:
        raise NotImplementedError("combining across a sharded KV cache is "
                                  "not ported yet (ROADMAP item 14)")
    o, _, l = parts
    return (o / l.clamp_min(1e-30)[..., None]).to(o.dtype)
