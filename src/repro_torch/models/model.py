"""The decoder LM: ``loss`` for training, ``forward``, ``prefill`` and
``decode_step`` for serving; the JAX package's ``repro.models.model.LM``
for attention decoders, dense (``block == "attn"``) and mixture-of-experts
(``block == "moe"``, with ``dense_residual``), and for the sub-quadratic
blocks, RWKV-6 (``"rwkv"``) and Hymba (``"hymba"``).  A decoder with
``embeds_input`` (Qwen2-VL's backbone, whose vision frontend is a stub)
reads ``batch["embeds"]`` ``[B, S, D]`` in place of ``tokens``, and one
with ``rope == "mrope"`` reads its M-RoPE ids ``batch["positions"]`` ``[3,
B, S]`` (temporal, height, width); its decode step reads ``embed1`` ``[B,
1, D]`` when given (else the table's row of ``token``) and sets all three
ids to ``pos``, as the reference does.

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
card (none for RWKV).  The decode cache holds each layer's keys and values
and, for RWKV and Hymba, the recurrent states the prefill leaves
(:func:`repro_torch.models.transformer.init_cache`).  ``loss`` runs
under autograd, each layer under
``torch.utils.checkpoint`` when ``cfg.remat`` (as the JAX package wraps
its layer in ``jax.checkpoint``), so the backward runs each layer's
forward, K6 included, once more.  An MoE block's auxiliary load-balancing
loss is summed over the layers, as the reference's ``_stack`` carries it,
and ``loss`` adds ``AUX_COEF`` times it.  The serving entry points run
without autograd.

:meth:`LM.shard_` cuts the weights to this rank's shards of a training
mesh (``train/sharding.py``'s specs), after which every entry point runs
SPMD over the mesh: each takes this rank's part of the batch
(``batch_spec``) and the cache's block (``cache_spec``); the embedding
and the tied head are vocab-parallel, so ``loss`` is a vocab-parallel
float32 log-softmax, the mean over the global batch; the experts are
expert-parallel over ``model`` and the auxiliary loss is the global
batch's.  ``forward``, ``prefill`` and ``decode_step`` return whole-vocab
logits.  RWKV's and Hymba's recurrent states are split over heads where
the heads divide ``model`` (``cache_spec``).

:class:`EncDecLM` is Whisper's encoder-decoder (the JAX package's
``EncDecLM``): ``batch["frames"]`` ``[B, F, D]`` (the audio frontend is a
stub: precomputed frame embeddings) go through the encoder, and the
decoder reads ``tokens`` with a cross-attention over the encoder's output
in each layer; both add the fixed sinusoidal table.  :meth:`LM.shard_`
cuts it as it cuts the decoder (the encoder's blocks, the decoder's
self-attention and cross-attention tensor-parallel over ``model`` and
FSDP over ``data``; ``batch["frames"]`` split along the batch as
``tokens`` is), and its decode cache's ``k``/``v`` are split along the
sequence over ``model`` while ``xk``/``xv`` stay whole on every rank.

    lm = build_model(get_config("whisper-base")).init(generator)
    logits = lm.forward({"frames": frames, "tokens": tokens})
    last, cache = lm.prefill({"frames": frames, "tokens": prompt},
                             lm.init_cache(batch, max_len))
    logits, cache = lm.decode_step(cache, {"token": tok, "pos": s})
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from ..parallel.collectives import all_gather, all_reduce, reduce
from ..parallel.mesh import mesh_axes, shard
from .config import ModelConfig
from .layers import (embed_init, embed_lookup, is_tp, parameter, rms_norm,
                     sinusoidal_positions, tied_logits)
from .transformer import (Block, CrossBlock, block_apply, block_attend,
                          block_decode, check_supported, cross_block_attend,
                          cross_block_decode, init_cache)

AUX_COEF = 0.01


def _positions_for(cfg: ModelConfig, batch: Dict[str, Any], x: torch.Tensor
                   ) -> Optional[torch.Tensor]:
    """The rotary positions of the embedded input ``x [B, S, D]``: none,
    the batch's M-RoPE ids ``[3, B, S]``, or ``0 .. S-1`` ``[B, S]``."""
    if cfg.rope == "none":
        return None
    if cfg.rope == "mrope":
        return batch["positions"]
    b, s = x.shape[:2]
    return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)


class LM(nn.Module):
    """Decoder-only language model (attention blocks, dense or MoE; RWKV;
    Hymba).

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
        self._build_layers(cfg, dev, trainable)
        self.final_norm = parameter((cfg.d_model,), torch.float32, dev,
                                    trainable)
        self.mesh = None

    def _build_layers(self, cfg: ModelConfig, dev: torch.device,
                      trainable: bool) -> None:
        self.blocks = nn.ModuleList(Block(cfg, dev, trainable)
                                    for _ in range(cfg.n_layers))

    def _layers(self):
        """Every block, in the order :meth:`init` draws them."""
        return list(self.blocks)

    @torch.no_grad()
    def shard_(self, mesh, specs: Dict[str, Any]) -> "LM":
        """Keep only this rank's shard of every weight on ``mesh`` (a
        :class:`repro_torch.parallel.mesh.Mesh` with groups), as ``specs``
        (``{name: spec}``, ``train.sharding.param_shardings``) lays it
        out; each parameter carries its ``spec``, its ``mesh`` and its
        ``global_shape``.  From here on the entry points run over the
        mesh."""
        if self.mesh is not None:
            raise ValueError("the model is already sharded")
        for name, p in self.named_parameters():
            p.global_shape = tuple(p.shape)
            p.data = shard(p.data, specs[name], mesh).clone()
            p.spec, p.mesh = specs[name], mesh
        self.mesh = mesh
        return self

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
        for blk in self._layers():
            blk.init_(generator)
        self.final_norm.fill_(1.0)
        return self

    # ------------------------------------------------------------- forward
    def _embed_in(self, batch: Dict[str, Any]) -> torch.Tensor:
        """``[B, S, D]`` in the activation dtype: ``batch["embeds"]`` with
        ``cfg.embeds_input``, else the table's rows of ``tokens``."""
        if self.cfg.embeds_input:
            return batch["embeds"].to(self.cfg.act_dtype())
        return embed_lookup(self.embed, batch["tokens"], self.mesh).to(
            self.cfg.act_dtype())

    def _logits(self, batch: Dict[str, Any]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(logits [B, S, V], aux)``: the logits (over a vocab-parallel
        mesh, this rank's ``V / tp``) and the auxiliary loss summed over
        the layers (``None`` without experts); under autograd with
        ``cfg.remat``, each layer runs under ``checkpoint``, which keeps
        only its input."""
        cfg = self.cfg
        x = self._embed_in(batch)
        positions = _positions_for(cfg, batch, x)
        remat = cfg.remat and torch.is_grad_enabled()
        aux = None
        for blk in self.blocks:
            if remat:
                x, a = checkpoint(block_apply, blk, x, cfg, positions, True,
                                  self.mesh, use_reentrant=False)
            else:
                x, a = block_apply(blk, x, cfg, positions, True, self.mesh)
            if a is not None:
                aux = a if aux is None else aux + a
        x = rms_norm(x, self.final_norm)
        return tied_logits(self.embed, x, fp32=cfg.logits_fp32,
                           mesh=self.mesh), aux

    def _vocab_parallel(self) -> bool:
        return self.mesh is not None and is_tp(self.embed)

    def _whole_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        if not self._vocab_parallel():
            return logits
        return all_gather(logits, logits.dim() - 1, self.mesh.group("model"))

    @torch.no_grad()
    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Logits ``[B, S, V]`` of ``batch["tokens"]`` ``[B, S]`` (or of
        ``embeds``, module docstring; the JAX package also returns MoE's
        auxiliary loss, which ``loss`` reports)."""
        return self._whole_vocab(self._logits(batch)[0])

    # ---------------------------------------------------------------- loss
    def _nll(self, logits: torch.Tensor, labels: torch.Tensor
             ) -> torch.Tensor:
        """The negative log-likelihood of each label under a float32
        log-softmax; vocab-parallel over a mesh (the max, the sum of
        exponentials and the label's logit combined over ``model``)."""
        lf = logits.float()
        if not self._vocab_parallel():
            lp = torch.log_softmax(lf, dim=-1)
            return -lp.gather(-1, labels.long()[..., None])[..., 0]
        grp = self.mesh.group("model")
        v_local = lf.shape[-1]
        top = all_reduce(lf.detach().amax(dim=-1, keepdim=True), grp, "max")
        z = lf - top
        sum_exp = reduce(torch.exp(z).sum(dim=-1), grp)
        local = labels.long() - self.mesh.coords["model"] * v_local
        ok = (local >= 0) & (local < v_local)
        picked = z.gather(-1, local.clamp(0, v_local - 1)[..., None])[..., 0]
        picked = reduce(torch.where(ok, picked, torch.zeros_like(picked)),
                        grp)
        return torch.log(sum_exp) - picked

    def loss(self, batch: Dict[str, Any]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``(total, {"ce", "aux", "ppl_proxy"})`` for ``batch["tokens"]``
        and ``batch["labels"]`` ``[B, S]``: the mean negative
        log-likelihood of the labels under a float32 log-softmax of the
        logits, plus ``AUX_COEF * aux``, the MoE blocks' auxiliary loss
        summed over the layers (0 for dense blocks); ``ppl_proxy =
        exp(min(ce, 20))``.  ``total`` carries the graph; the metrics are
        detached.  Over a mesh the mean is over the global batch (every
        data rank's part), equal on every rank, and so is ``aux``."""
        logits, aux = self._logits(batch)
        nll = self._nll(logits, batch["labels"])
        if self.mesh is None:
            ce = nll.mean()
        else:
            fsdp, _ = mesh_axes(self.mesh)
            ce = nll.sum() / (nll.numel() * self.mesh.axis_size(fsdp))
            for axis in fsdp:
                ce = reduce(ce, self.mesh.group(axis))
        if aux is None:
            total, aux = ce, torch.zeros_like(ce)
        else:
            total = ce + AUX_COEF * aux
        ce = ce.detach()
        return total, {"ce": ce, "aux": aux.detach(),
                       "ppl_proxy": torch.exp(torch.clamp(ce, max=20.0))}

    # ------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, batch: Dict[str, Any],
                cache: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns (last-position logits [B, V], cache).

        The prompt's keys and values go into ``cache`` (from
        :meth:`init_cache`, at least as long as the prompt) in place, at
        positions ``0 .. S-1``, and RWKV's and Hymba's recurrent states
        after the prompt beside them; without one, a cache of exactly the
        prompt's length ``[L, B, S, Hkv, hd]`` is returned.  Over a mesh
        ``cache`` is this rank's block (``cache_spec``: its slice of the
        positions), and each rank writes the positions it holds."""
        cfg, mesh = self.cfg, self.mesh
        x = self._embed_in(batch)
        b, s, _ = x.shape
        if cache is None:
            cache = self._prompt_cache(cfg, b, s, x.device)
        off, n = self._prompt_span(cache, b, s)
        positions = _positions_for(cfg, batch, x)
        for i, blk in enumerate(self.blocks):
            out = block_attend(blk, x, cfg, positions, True, mesh)
            x = out.x
            if out.k is not None:
                self._keep_kv(cache, i, dict(k=out.k, v=out.v), off, n)
            for name, t in (out.state or {}).items():
                cache[name][i] = t
        x = rms_norm(x[:, -1:], self.final_norm)
        logits = tied_logits(self.embed, x, fp32=cfg.logits_fp32, mesh=mesh)
        return self._whole_vocab(logits)[:, 0], cache

    # ---------------------------------------------------------- decode step
    @torch.no_grad()
    def decode_step(self, cache: Dict[str, torch.Tensor],
                    batch: Dict[str, Any], seq_axis: Optional[str] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One token for the whole batch.  batch: {"token": [B, 1], "pos":
        the position being written (an int; RWKV, which keeps no keys,
        reads none)} and, with ``cfg.embeds_input``, ``"embed1"`` [B, 1,
        D] in place of the token's row of the table; with M-RoPE all three
        ids are ``pos``.  Returns (logits [B, V], cache), the cache updated
        in place.  Over a mesh the cache's sequence axis is split over
        ``seq_axis`` (``"model"``: the ``cache_spec`` layout)."""
        cfg, mesh = self.cfg, self.mesh
        self._check_seq_axis(seq_axis)
        pos = int(batch["pos"])
        if cfg.embeds_input and "embed1" in batch:
            x1 = batch["embed1"][:, 0].to(cfg.act_dtype())
        else:
            x1 = embed_lookup(self.embed, batch["token"][:, 0], mesh).to(
                cfg.act_dtype())
        positions = None
        if cfg.rope != "none":
            lead = (3,) if cfg.rope == "mrope" else ()
            positions = torch.full(lead + (x1.shape[0], 1), pos,
                                   dtype=torch.int32, device=x1.device)
        for i, blk in enumerate(self.blocks):
            layer = {name: t[i] for name, t in cache.items()}
            x1, _ = block_decode(blk, x1, layer, cfg, pos, positions, mesh,
                                 seq_axis)
        x1 = rms_norm(x1, self.final_norm)
        logits = tied_logits(self.embed, x1, fp32=cfg.logits_fp32, mesh=mesh)
        return self._whole_vocab(logits), cache

    def _check_seq_axis(self, seq_axis: Optional[str]) -> None:
        if self.mesh is not None and seq_axis != "model":
            raise ValueError("over a mesh the decode cache is split along "
                             "its sequence axis over 'model' (cache_spec): "
                             "pass seq_axis='model'")

    def _prompt_cache(self, cfg: ModelConfig, b: int, s: int,
                      device: torch.device) -> Dict[str, torch.Tensor]:
        """The cache a prefill of ``b`` prompts of ``s`` tokens makes when
        given none: exactly the prompts' length; over a mesh this rank's
        block (its part of the batch: ``b`` rows of ``b`` times the FSDP
        axes' size, which ``cache_spec`` splits back to ``b``; its slice
        of S; the recurrent states' heads where they split)."""
        mesh = self.mesh
        tp = 1 if mesh is None else mesh.shape["model"]
        if s % tp and cfg.block != "rwkv":     # a KV cache to split
            raise ValueError(f"a prompt of {s} does not split over {tp} "
                             f"ranks; pass a cache")
        n_fsdp = 1 if mesh is None else mesh.axis_size(mesh_axes(mesh)[0])
        return init_cache(cfg, b * n_fsdp, s, device, mesh)

    def _prompt_span(self, cache: Dict[str, torch.Tensor], b: int, s: int
                     ) -> Tuple[int, int]:
        """``(off, n)``: this rank's slice of a prompt of ``s`` positions
        in ``cache`` (positions ``off .. off + n - 1``, at ``0 .. n - 1``
        of its block); raises if ``cache`` does not hold ``b`` prompts of
        ``s`` tokens."""
        tp = 1 if self.mesh is None else self.mesh.shape["model"]
        some = next(iter(cache.values()))
        if some.shape[1] != b or ("k" in cache
                                  and cache["k"].shape[2] * tp < s):
            raise ValueError(f"cache {tuple(some.shape)} does not hold "
                             f"{b} prompts of {s} tokens")
        s_local = cache["k"].shape[2] if "k" in cache else s
        off = 0 if self.mesh is None else self.mesh.coords["model"] * s_local
        return off, max(0, min(s - off, s_local))

    def _keep_kv(self, cache: Dict[str, torch.Tensor], i: int,
                 kv: Dict[str, torch.Tensor], off: int, n: int) -> None:
        """Write layer ``i``'s keys and values ``kv`` (``k``/``v`` over the
        prompt, ``xk``/``xv`` over the frames; over a mesh this rank's
        heads where the heads route split them, gathered whole here) into
        this rank's block of ``cache``: ``k``/``v`` at its slice ``off ..
        off + n - 1`` of the positions, ``xk``/``xv`` whole."""
        for name, t in kv.items():
            if t.shape[2] != self.cfg.n_kv_heads:   # this rank's heads
                t = all_gather(t, 2, self.mesh.group("model"))
            if name in ("k", "v"):
                cache[name][i, :, :n] = t[:, off:off + n]
            else:
                cache[name][i] = t

    def init_cache(self, batch: int, seq: int) -> Dict[str, torch.Tensor]:
        """A zeroed cache for ``batch`` prompts of up to ``seq`` tokens
        (over a mesh, the global sizes; this rank's block returned)."""
        return init_cache(self.cfg, batch, seq, self.device, self.mesh)


class EncDecLM(LM):
    """Whisper-style encoder-decoder: ``embed`` (tied head), ``enc`` (the
    encoder's ``cfg.enc_layers`` :class:`Block` s, run non-causally),
    ``dec`` (``cfg.n_layers`` :class:`CrossBlock` s), ``enc_norm`` and
    ``final_norm``.  ``loss`` is :class:`LM`'s, with no auxiliary loss.
    Layers run one after another, none under ``checkpoint`` (the
    reference unrolls them without ``jax.checkpoint``); every attention
    is K6 on the card: the encoder's non-causal, the decoder's causal
    self-attention and its cross-attention at ``Sq != Skv``.

    Over a training mesh (:meth:`LM.shard_`) it runs SPMD as :class:`LM`
    does: every attention on the route of its query rows
    (:func:`repro_torch.models.attention.attention_route`), the tied head
    vocab-parallel where the vocab divides ``model`` (else replicated),
    ``frames`` and ``tokens`` this rank's part of the batch, the cache
    this rank's block of ``cache_spec`` (``k``/``v`` its slice of the
    positions, ``xk``/``xv`` whole) and ``decode_step`` with
    ``seq_axis="model"``."""

    def _build_layers(self, cfg: ModelConfig, dev: torch.device,
                      trainable: bool) -> None:
        self.enc = nn.ModuleList(Block(cfg, dev, trainable)
                                 for _ in range(cfg.enc_layers))
        self.dec = nn.ModuleList(CrossBlock(cfg, dev, trainable)
                                 for _ in range(cfg.n_layers))
        self.enc_norm = parameter((cfg.d_model,), torch.float32, dev,
                                  trainable)

    def _layers(self):
        return list(self.enc) + list(self.dec)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "EncDecLM":
        super().init(generator)
        self.enc_norm.fill_(1.0)
        return self

    def _positioned(self, x: torch.Tensor) -> torch.Tensor:
        """``x [B, S, D]`` plus the sinusoidal table's first ``S`` rows,
        in ``x``'s dtype."""
        tab = sinusoidal_positions(x.shape[1], self.cfg.d_model, x.device)
        return x + tab.to(x.dtype)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The encoder's output ``[B, F, D]`` of ``frames [B, F, D]``: the
        frames in the activation dtype plus the sinusoidal table, the
        encoder blocks (non-causal), ``enc_norm``."""
        x = self._positioned(frames.to(self.cfg.act_dtype()))
        for blk in self.enc:
            x, _ = block_apply(blk, x, self.cfg, None, False, self.mesh)
        return rms_norm(x, self.enc_norm)

    def _decoder_in(self, tokens: torch.Tensor) -> torch.Tensor:
        x = embed_lookup(self.embed, tokens, self.mesh).to(
            self.cfg.act_dtype())
        return self._positioned(x)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """The tied head's logits of ``x`` after ``final_norm`` (over a
        vocab-parallel mesh, this rank's ``V / tp``)."""
        return tied_logits(self.embed, rms_norm(x, self.final_norm),
                           fp32=self.cfg.logits_fp32, mesh=self.mesh)

    def _logits(self, batch: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(logits [B, S, V], None)`` of ``batch["frames"]`` and
        ``batch["tokens"]`` (over a vocab-parallel mesh, this rank's ``V /
        tp``)."""
        enc_out = self.encode(batch["frames"])
        x = self._decoder_in(batch["tokens"])
        for blk in self.dec:
            x = cross_block_attend(blk, x, enc_out, self.cfg, self.mesh).x
        return self._head(x), None

    @torch.no_grad()
    def prefill(self, batch: Dict[str, Any],
                cache: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns (last-position logits [B, V], cache) for
        ``batch["frames"]`` ``[B, F, D]`` and the prompt
        ``batch["tokens"]`` ``[B, S]``.  The prompt's keys and values go
        into ``cache`` (from :meth:`init_cache`, at least ``S`` long and
        with ``F`` encoder positions) in place at ``0 .. S-1``, and each
        layer's cross-attention keys and values of the encoder's output
        into ``xk``/``xv``; without one, a cache of exactly the prompt's
        length is returned.  Over a mesh ``cache`` is this rank's block:
        each rank writes the positions it holds, and ``xk``/``xv``
        whole."""
        cfg = self.cfg
        frames, tokens = batch["frames"], batch["tokens"]
        b, s = tokens.shape
        if cache is None:
            cache = self._prompt_cache(cfg.replace(enc_frames=frames.shape[1]),
                                       b, s, self.device)
        off, n = self._prompt_span(cache, b, s)
        if cache["xk"].shape[2] != frames.shape[1]:
            raise ValueError(f"cache xk {tuple(cache['xk'].shape)} does not "
                             f"hold {frames.shape[1]} frames")
        enc_out = self.encode(frames)
        x = self._decoder_in(tokens)
        for i, blk in enumerate(self.dec):
            out = cross_block_attend(blk, x, enc_out, cfg, self.mesh)
            x = out.x
            self._keep_kv(cache, i, dict(k=out.k, v=out.v, **out.state),
                          off, n)
        return self._whole_vocab(self._head(x[:, -1:]))[:, 0], cache

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, torch.Tensor],
                    batch: Dict[str, Any], seq_axis: Optional[str] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One token for the whole batch: ``batch`` {"token": [B, 1],
        "pos": the position written}; the token's embedding plus the
        sinusoidal table's row ``pos``, then each decoder layer against
        its cache (:func:`cross_block_decode`).  Returns (logits [B, V],
        cache), the cache updated in place.  Over a mesh the cache's
        sequence axis is split over ``seq_axis`` (``"model"``: the
        ``cache_spec`` layout)."""
        cfg, mesh = self.cfg, self.mesh
        self._check_seq_axis(seq_axis)
        pos = int(batch["pos"])
        x1 = embed_lookup(self.embed, batch["token"][:, 0], mesh).to(
            cfg.act_dtype())
        x1 = x1 + sinusoidal_positions(pos + 1, cfg.d_model,
                                       x1.device)[pos].to(x1.dtype)
        for i, blk in enumerate(self.dec):
            x1, _ = cross_block_decode(
                blk, x1, {name: t[i] for name, t in cache.items()}, cfg, pos,
                mesh, seq_axis)
        return self._whole_vocab(self._head(x1)), cache


def build_model(cfg: ModelConfig, device=None,
                trainable: bool = False) -> LM:
    """The model for ``cfg`` on ``device`` (``None``: the CUDA card), with
    uninitialised weights, trainable or not: :class:`EncDecLM` for
    ``cfg.enc_dec`` (Whisper), else :class:`LM`.  Raises
    ``NotImplementedError`` for a model kind the port does not build
    (:func:`repro_torch.models.transformer.check_supported`)."""
    return (EncDecLM if cfg.enc_dec else LM)(cfg, device, trainable)
