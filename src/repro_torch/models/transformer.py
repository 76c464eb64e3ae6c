"""Decoder blocks: full-sequence apply (training's forward and the
prefill), one-token decode against a preallocated KV cache, and the cache
itself; the JAX package's ``repro.models.transformer`` for ``block ==
"attn"`` on one device.

The full-sequence attention is :func:`repro_torch.kernels.ops
.flash_attention` (K6 on the card, its plain version on the host), under
autograd where the weights are trainable.  The decode step writes the new
token's key and value into the cache in place, at ``pos``, instead of
returning an updated copy.  MoE, RWKV and Hymba blocks, the
sequence-sharded decode and the encoder-decoder blocks wait for later
slices (ROADMAP item 14).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..kernels import ops
from .attention import (AttnParams, combine_partials, decode_partial,
                        qkv_project)
from .config import ModelConfig
from .layers import parameter, rms_norm
from .mlp import MlpParams, mlp_apply


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not build yet."""
    why = None
    if cfg.block != "attn":
        why = f"block {cfg.block!r}"
    elif cfg.rope == "mrope":
        why = "M-RoPE"
    elif cfg.enc_dec:
        why = "encoder-decoder models"
    elif cfg.embeds_input:
        why = "embedding inputs (a modality frontend)"
    if why is not None:
        raise NotImplementedError(
            f"{cfg.name}: {why} not ported yet (ROADMAP item 14); the port "
            f"builds dense attention decoders with RoPE")


class Block(nn.Module):
    """One attention + MLP block: ``norm1``, ``attn``, ``norm2``, ``mlp``
    (trainable weights take gradients)."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 trainable: bool = False):
        super().__init__()
        check_supported(cfg)
        self.norm1 = parameter((cfg.d_model,), torch.float32, device,
                               trainable)
        self.norm2 = parameter((cfg.d_model,), torch.float32, device,
                               trainable)
        self.attn = AttnParams(cfg, device, trainable)
        self.mlp = MlpParams(cfg, device, trainable=trainable)

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "Block":
        self.norm1.fill_(1.0)
        self.norm2.fill_(1.0)
        self.attn.init_(generator)
        self.mlp.init_(generator)
        return self


def block_init(generator: torch.Generator, cfg: ModelConfig) -> Block:
    return Block(cfg, generator.device).init_(generator)


def block_attend(p: Block, x: torch.Tensor, cfg: ModelConfig,
                 positions: Optional[torch.Tensor], causal: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence block; returns ``(x, k, v)`` with the block's keys and
    values ``[B, S, Hkv, hd]`` for the prefill's cache."""
    n1 = rms_norm(x, p.norm1)
    q, k, v = qkv_project(p.attn, n1, cfg, positions)
    ao = ops.flash_attention(q, k, v, causal=causal)
    b, s, hq, hd = ao.shape
    x = x + ao.reshape(b, s, hq * hd) @ p.attn.wo.to(x.dtype)
    n2 = rms_norm(x, p.norm2)
    return x + mlp_apply(p.mlp, n2, cfg.mlp), k, v


def block_apply(p: Block, x: torch.Tensor, cfg: ModelConfig,
                positions: Optional[torch.Tensor],
                causal: bool = True) -> torch.Tensor:
    """Full-sequence block (training's forward and ``LM.forward``).  The
    JAX package also returns an auxiliary loss, which only MoE blocks
    make."""
    return block_attend(p, x, cfg, positions, causal)[0]


# ------------------------------------------------------- decode attention ---

def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, new_k: torch.Tensor,
                     new_v: torch.Tensor, pos: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention against the KV cache.

    q [B,Hq,hd]; cache_k/v [B,S,Hkv,hd]; new_k/v [B,Hkv,hd]; ``pos`` the
    position written.  The new key and value are written into the cache in
    place; returns ``(out [B,Hq,hd], cache_k, cache_v)``."""
    b, s = cache_k.shape[:2]
    if not 0 <= pos < s:
        raise ValueError(f"decode position {pos} outside the cache's {s}")
    cache_k[:, pos] = new_k
    cache_v[:, pos] = new_v
    valid = (torch.arange(s, device=q.device) <= pos)[None].expand(b, s)
    part = decode_partial(q, cache_k, cache_v, valid)
    return combine_partials(part).to(q.dtype), cache_k, cache_v


def block_decode(p: Block, x1: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cfg: ModelConfig, pos: int,
                 positions: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token block step.  x1 [B, D]; ``cache`` holds this layer's
    ``k``/``v`` [B, S, Hkv, hd], updated in place.  Returns (x1, cache)."""
    n1 = rms_norm(x1, p.norm1)
    q, k, v = qkv_project(p.attn, n1[:, None], cfg, positions)
    o, _, _ = decode_attention(q[:, 0], cache["k"], cache["v"], k[:, 0],
                               v[:, 0], pos)
    x1 = x1 + o.reshape(x1.shape[0], -1) @ p.attn.wo.to(x1.dtype)
    n2 = rms_norm(x1, p.norm2)
    return x1 + mlp_apply(p.mlp, n2[:, None], cfg.mlp)[:, 0], cache


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """Zeroed decode cache, stacked over layers: ``k``/``v``
    [L, B, S, Hkv, hd] in the activation dtype."""
    check_supported(cfg)
    shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.hd)
    return {name: torch.zeros(shape, dtype=cfg.act_dtype(), device=device)
            for name in ("k", "v")}
