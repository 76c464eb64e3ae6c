"""The decoder LM: ``loss`` for training, ``forward``, ``prefill`` and
``decode_step`` for serving; the JAX package's ``repro.models.model.LM`` on
one device.

    lm = build_model(cfg).init(torch.Generator("cuda").manual_seed(0))
    logits = lm.forward({"tokens": tokens})                  # [B, S, V]
    cache = lm.init_cache(batch, max_len)
    last, cache = lm.prefill({"tokens": prompts}, cache)     # [B, V]
    logits, cache = lm.decode_step(cache, {"token": tok, "pos": s})

    lm = build_model(cfg, trainable=True).init(generator)
    total, metrics = lm.loss({"tokens": tokens, "labels": labels})

The module holds its weights (``embed``, ``blocks.{i}.*``, ``final_norm``;
:func:`repro_torch.models.convert.params_from_jax` maps the JAX package's
parameters onto them); they take gradients only in a model built
``trainable``.  Layers run one after another in a Python loop; the
attention over a sequence is the flash kernel, one launch per layer on the
card.  ``loss`` runs under autograd, each layer under
``torch.utils.checkpoint`` when ``cfg.remat`` (as the JAX package wraps
its layer in ``jax.checkpoint``), so the backward runs each layer's
forward, K6 included, once more.  The serving entry points run without
autograd.  The encoder-decoder waits for a later slice (ROADMAP item 14).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from .config import ModelConfig
from .layers import (embed_init, embed_lookup, parameter, rms_norm,
                     tied_logits)
from .transformer import (Block, block_apply, block_attend, block_decode,
                          check_supported, init_cache)

AUX_COEF = 0.01


def _positions_for(cfg: ModelConfig, batch: Dict[str, Any], seq: int
                   ) -> Optional[torch.Tensor]:
    if cfg.rope == "none":
        return None
    tokens = batch["tokens"]
    return torch.arange(seq, dtype=torch.int32,
                        device=tokens.device).expand(tokens.shape[0], seq)


class LM(nn.Module):
    """Decoder-only language model (dense attention blocks).

    Args:
        cfg: the model's configuration.
        device: ``None`` (the CUDA card) or a device; the weights are
            allocated there, uninitialised until :meth:`init` or
            ``load_state_dict``.
        trainable: the weights take gradients (training); serving's do
            not.
    """

    def __init__(self, cfg: ModelConfig, device=None,
                 trainable: bool = False):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = parameter((cfg.vocab, cfg.d_model), cfg.p_dtype(), dev,
                               trainable)
        self.blocks = nn.ModuleList(Block(cfg, dev, trainable)
                                    for _ in range(cfg.n_layers))
        self.final_norm = parameter((cfg.d_model,), torch.float32, dev,
                                    trainable)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ---------------------------------------------------------------- init
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "LM":
        """Random weights from ``generator`` (on the model's device)."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        cfg = self.cfg
        self.embed.copy_(embed_init(generator, cfg.vocab, cfg.d_model,
                                    cfg.p_dtype()))
        for blk in self.blocks:
            blk.init_(generator)
        self.final_norm.fill_(1.0)
        return self

    # ------------------------------------------------------------- forward
    def _embed_in(self, batch: Dict[str, Any]) -> torch.Tensor:
        return embed_lookup(self.embed, batch["tokens"]).to(
            self.cfg.act_dtype())

    def _logits(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Logits ``[B, S, V]``; under autograd with ``cfg.remat``, each
        layer runs under ``checkpoint``, which keeps only its input."""
        cfg = self.cfg
        x = self._embed_in(batch)
        positions = _positions_for(cfg, batch, x.shape[1])
        remat = cfg.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            if remat:
                x = checkpoint(block_apply, blk, x, cfg, positions,
                               use_reentrant=False)
            else:
                x = block_apply(blk, x, cfg, positions)
        x = rms_norm(x, self.final_norm)
        return tied_logits(self.embed, x, fp32=cfg.logits_fp32)

    @torch.no_grad()
    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Logits ``[B, S, V]`` of ``batch["tokens"]`` ``[B, S]`` (the JAX
        package also returns MoE's auxiliary loss)."""
        return self._logits(batch)

    # ---------------------------------------------------------------- loss
    def loss(self, batch: Dict[str, Any]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``(total, {"ce", "aux", "ppl_proxy"})`` for ``batch["tokens"]``
        and ``batch["labels"]`` ``[B, S]``: the mean negative
        log-likelihood of the labels under a float32 log-softmax of the
        logits, plus ``AUX_COEF * aux`` (0: dense blocks make no auxiliary
        loss); ``ppl_proxy = exp(min(ce, 20))``.  ``total`` carries the
        graph; the metrics are detached."""
        logits = self._logits(batch)
        lp = torch.log_softmax(logits.float(), dim=-1)
        nll = -lp.gather(-1, batch["labels"].long()[..., None])[..., 0]
        ce = nll.mean()
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        total = ce + AUX_COEF * aux
        ce = ce.detach()
        return total, {"ce": ce, "aux": aux,
                       "ppl_proxy": torch.exp(torch.clamp(ce, max=20.0))}

    # ------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, batch: Dict[str, Any],
                cache: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns (last-position logits [B, V], cache).

        The prompt's keys and values go into ``cache`` (from
        :meth:`init_cache`, at least as long as the prompt) in place, at
        positions ``0 .. S-1``; without one, a cache of exactly the
        prompt's length ``[L, B, S, Hkv, hd]`` is returned."""
        cfg = self.cfg
        x = self._embed_in(batch)
        b, s, _ = x.shape
        if cache is None:
            shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.hd)
            cache = {name: torch.empty(shape, dtype=x.dtype, device=x.device)
                     for name in ("k", "v")}
        elif cache["k"].shape[1] != b or cache["k"].shape[2] < s:
            raise ValueError(f"cache {tuple(cache['k'].shape)} does not hold "
                             f"{b} prompts of {s} tokens")
        positions = _positions_for(cfg, batch, s)
        for i, blk in enumerate(self.blocks):
            x, k, v = block_attend(blk, x, cfg, positions, causal=True)
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
        x = rms_norm(x[:, -1:], self.final_norm)
        logits = tied_logits(self.embed, x, fp32=cfg.logits_fp32)
        return logits[:, 0], cache

    # ---------------------------------------------------------- decode step
    @torch.no_grad()
    def decode_step(self, cache: Dict[str, torch.Tensor],
                    batch: Dict[str, Any]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One token for the whole batch.  batch: {"token": [B, 1], "pos":
        the position being written (an int)}.  Returns (logits [B, V],
        cache), the cache updated in place."""
        cfg = self.cfg
        pos = int(batch["pos"])
        x1 = embed_lookup(self.embed, batch["token"][:, 0]).to(
            cfg.act_dtype())
        positions = None
        if cfg.rope == "rope":
            positions = torch.full((x1.shape[0], 1), pos, dtype=torch.int32,
                                   device=x1.device)
        for i, blk in enumerate(self.blocks):
            layer = {"k": cache["k"][i], "v": cache["v"][i]}
            x1, _ = block_decode(blk, x1, layer, cfg, pos, positions)
        x1 = rms_norm(x1, self.final_norm)
        return tied_logits(self.embed, x1, fp32=cfg.logits_fp32), cache

    def init_cache(self, batch: int, seq: int) -> Dict[str, torch.Tensor]:
        return init_cache(self.cfg, batch, seq, self.device)


def build_model(cfg: ModelConfig, device=None,
                trainable: bool = False) -> LM:
    """The model for ``cfg`` on ``device`` (``None``: the CUDA card), with
    uninitialised weights, trainable or not (:class:`LM`).  Raises
    ``NotImplementedError`` for the blocks, RoPE variants and model kinds
    the port does not build yet."""
    return LM(cfg, device, trainable)
