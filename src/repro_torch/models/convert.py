"""Weights carried across from the JAX package.

:func:`params_from_jax` maps the parameters of the JAX package's
``LM.init`` (as numpy arrays) onto the state dict of
:class:`repro_torch.models.model.LM`.  The port keeps the JAX layout of
every weight (projections ``[d_in, d_out]``, applied as ``x @ w``, not
``nn.Linear``'s ``[d_out, d_in]``), so nothing is transposed: the stacked
``[L, ...]`` block parameters are split per layer and renamed.  The
encoder-decoder's ``enc`` and ``dec`` are lists of per-layer parameters
in the reference already (``EncDecLM.init``), and are renamed only.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .config import ModelConfig
from .rwkv import RwkvParams
from .ssm import SsmParams


def _field(tree: Any, name: str) -> Any:
    """``tree[name]`` for a mapping, ``tree.name`` for a named tuple."""
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16 numpy arrays
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(params_np: Mapping[str, Any],
                    cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The JAX ``LM.init`` pytree as numpy arrays -> ``LM``'s state dict.

    ``params_np`` holds ``embed`` [V, D], ``final_norm`` [D] and
    ``blocks``, stacked over layers: ``norm1``/``norm2`` [L, D] and, by
    ``cfg.block``: ``attn`` (``AttnParams``: ``wq``/``wk``/``wv``/``wo``
    and, with ``qkv_bias``, ``bq``/``bk``/``bv``) and ``mlp``
    (``MlpParams``: ``wi``/``wo`` and, for SwiGLU, ``wg``); for an MoE
    block ``attn``, ``moe`` (``MoeParams``: ``router`` [L, D, E],
    ``wi``/``wg`` [L, E, D, F], ``wo`` [L, E, F, D]) and, with
    ``dense_residual``, ``dense`` (an ``MlpParams``); for RWKV ``rwkv``
    (``RwkvParams``' 19 fields); for Hymba ``attn``, ``ssm``
    (``SsmParams``) and ``mlp``.  The arrays keep their dtype; the result
    goes to ``LM.load_state_dict``, which copies onto the model's
    device.

    For ``cfg.enc_dec`` (``EncDecLM.init``) ``params_np`` holds ``embed``,
    ``enc_norm`` and ``final_norm`` beside ``enc`` and ``dec``, lists of
    per-layer parameters: ``norm1``/``norm2``, ``attn`` and ``mlp``, and
    in ``dec`` also ``norm_x`` and ``xattn`` (an ``AttnParams``)."""
    attn_names = ["wq", "wk", "wv", "wo"]
    if cfg.qkv_bias:
        attn_names += ["bq", "bk", "bv"]
    mlp_names = ["wi", "wo"] + (["wg"] if cfg.mlp == "swiglu" else [])
    if cfg.enc_dec:
        return _enc_dec_state(params_np, cfg, attn_names, mlp_names)
    blocks = _field(params_np, "blocks")
    mods = {"attn": [("attn", attn_names), ("mlp", mlp_names)],
            "moe": [("attn", attn_names), ("moe", ["router"] + mlp_names)]
            + ([("dense", mlp_names)] if cfg.dense_residual else []),
            "rwkv": [("rwkv", list(RwkvParams.FIELDS))],
            "hymba": [("attn", attn_names), ("ssm", list(SsmParams.FIELDS)),
                      ("mlp", mlp_names)]}[cfg.block]
    state = {"embed": _tensor(_field(params_np, "embed")),
             "final_norm": _tensor(_field(params_np, "final_norm"))}
    stacked = [("norm1", _field(blocks, "norm1")),
               ("norm2", _field(blocks, "norm2"))]
    for mod, names in mods:
        tree = _field(blocks, mod)
        stacked += [(f"{mod}.{n}", _field(tree, n)) for n in names]
    for name, arr in stacked:
        if np.shape(arr)[0] != cfg.n_layers:
            raise ValueError(f"blocks.{name}: {np.shape(arr)[0]} layers, "
                             f"config has {cfg.n_layers}")
        for i in range(cfg.n_layers):
            state[f"blocks.{i}.{name}"] = _tensor(arr[i])
    return state


def _enc_dec_state(params_np: Mapping[str, Any], cfg: ModelConfig,
                   attn_names, mlp_names) -> Dict[str, torch.Tensor]:
    """``EncDecLM``'s state dict from the reference's per-layer lists."""
    state = {name: _tensor(_field(params_np, name))
             for name in ("embed", "enc_norm", "final_norm")}
    for stack, n_layers, extra in (("enc", cfg.enc_layers, ()),
                                   ("dec", cfg.n_layers, ("xattn",))):
        layers = list(_field(params_np, stack))
        if len(layers) != n_layers:
            raise ValueError(f"{stack}: {len(layers)} layers, config has "
                             f"{n_layers}")
        for i, layer in enumerate(layers):
            for norm in ("norm1", "norm2") + (("norm_x",) if extra else ()):
                state[f"{stack}.{i}.{norm}"] = _tensor(_field(layer, norm))
            for mod, names in [("attn", attn_names), ("mlp", mlp_names)] + [
                    (m, attn_names) for m in extra]:
                tree = _field(layer, mod)
                for n in names:
                    state[f"{stack}.{i}.{mod}.{n}"] = _tensor(_field(tree, n))
    return state
