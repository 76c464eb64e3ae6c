"""Input specifications per (architecture x shape) cell; the JAX package's
``repro.launch.specs``.

``train_batch``, ``prefill_batch`` and ``decode_batch`` return stand-ins
by default: tensors on the ``meta`` device with the reference's shapes
and dtypes, which allocate nothing (a ``decode_32k`` cache included).
``concrete=True`` materialises real tensors on ``device`` (``None``: the
CUDA card) from the reference's numpy generators (``default_rng(0)`` for
tokens, ``default_rng(1)`` for normals), so they equal the reference's
element for element.  Modality frontends are stubs, as in the reference:
VLM cells receive patch embeddings + M-RoPE ids, audio cells receive
precomputed frame embeddings.

    batch = train_batch(cfg, SHAPES["train_4k"])              # meta
    batch = train_batch(cfg, shape, concrete=True, device="cpu")
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.config import ModelConfig, ShapeConfig
from ..models.model import build_model

_META = torch.device("meta")


def _mk(shape, dtype: torch.dtype, concrete: bool, device,
        kind: str = "zeros", vocab: int = 0) -> torch.Tensor:
    if not concrete:
        return torch.empty(shape, dtype=dtype, device=_META)
    if kind == "tokens":
        rng = np.random.default_rng(0)
        a = torch.from_numpy(rng.integers(0, vocab, size=shape,
                                          dtype=np.int32))
    elif kind == "normal":
        rng = np.random.default_rng(1)
        a = torch.from_numpy(rng.normal(0, 1, size=shape).astype(
            np.float32)).to(dtype)
    else:
        a = torch.zeros(shape, dtype=dtype)
    return a.to(device)


def _device(concrete: bool, device) -> torch.device:
    return resolve_device(device) if concrete else _META


def train_batch(cfg: ModelConfig, shape: ShapeConfig,
                concrete: bool = False, device=None) -> Dict[str, Any]:
    """``tokens`` (or ``frames`` [B, enc_frames, D] and ``tokens``, or
    ``embeds`` [B, S, D] and M-RoPE ``positions`` [3, B, S]) and
    ``labels`` of a cell's global batch."""
    dev = _device(concrete, device)
    b, s = shape.global_batch, shape.seq_len
    bt: Dict[str, Any] = {}
    if cfg.enc_dec:
        bt["frames"] = _mk((b, cfg.enc_frames, cfg.d_model), torch.bfloat16,
                           concrete, dev, "normal")
        bt["tokens"] = _mk((b, s), torch.int32, concrete, dev, "tokens",
                           cfg.vocab)
    elif cfg.embeds_input:
        bt["embeds"] = _mk((b, s, cfg.d_model), torch.bfloat16, concrete,
                           dev, "normal")
        if cfg.rope == "mrope":
            # stub M-RoPE ids: sequential text positions on all three streams
            bt["positions"] = (
                torch.arange(s, dtype=torch.int32, device=dev).expand(
                    3, b, s).contiguous()
                if concrete else _mk((3, b, s), torch.int32, False, dev))
    else:
        bt["tokens"] = _mk((b, s), torch.int32, concrete, dev, "tokens",
                           cfg.vocab)
    bt["labels"] = _mk((b, s), torch.int32, concrete, dev, "tokens",
                       cfg.vocab)
    return bt


def prefill_batch(cfg: ModelConfig, shape: ShapeConfig,
                  concrete: bool = False, device=None) -> Dict[str, Any]:
    bt = train_batch(cfg, shape, concrete, device)
    bt.pop("labels")
    return bt


def decode_batch(cfg: ModelConfig, shape: ShapeConfig,
                 concrete: bool = False, device=None
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(one-token batch, full-length decode cache) for decode cells: the
    cache of a model built on the ``meta`` device (nothing allocated), or
    its zeros on ``device`` with ``concrete``."""
    dev = _device(concrete, device)
    b, s = shape.global_batch, shape.seq_len
    bt: Dict[str, Any] = {
        "token": _mk((b, 1), torch.int32, concrete, dev, "tokens",
                     cfg.vocab),
        "pos": (torch.tensor(s - 1, dtype=torch.int32, device=dev)
                if concrete else _mk((), torch.int32, False, dev)),
    }
    if cfg.embeds_input:
        bt["embed1"] = _mk((b, 1, cfg.d_model), torch.bfloat16, concrete,
                           dev, "normal")
    cache = build_model(cfg, device=_META).init_cache(b, s)
    if concrete:
        cache = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
                 for k, v in cache.items()}
    return bt, cache
