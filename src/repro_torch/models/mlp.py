"""Feed-forward variants: SwiGLU (llama-family), squared-ReLU (nemotron,
rwkv channel-mix), GELU (whisper); the JAX package's ``repro.models.mlp``,
tensor-parallel over a training mesh's ``model`` axis."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import copy_to, reduce
from .config import ModelConfig
from .layers import dense_init, is_tp, parameter, weight


class MlpParams(nn.Module):
    """``wi [D, F]``, ``wo [F, D]`` and, for SwiGLU, the gate ``wg [D, F]``
    (uninitialised until :meth:`init_`); trainable weights take
    gradients."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 d_ff: Optional[int] = None, trainable: bool = False):
        super().__init__()
        d, f, dt = cfg.d_model, d_ff or cfg.d_ff, cfg.p_dtype()
        self.wi = parameter((d, f), dt, device, trainable)
        self.wo = parameter((f, d), dt, device, trainable)
        self.wg = parameter((d, f), dt, device, trainable) \
            if cfg.mlp == "swiglu" else None

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "MlpParams":
        d, f = self.wi.shape
        self.wi.copy_(dense_init(generator, d, f, self.wi.dtype))
        self.wo.copy_(dense_init(generator, f, d, self.wo.dtype,
                                 scale=f ** -0.5))
        if self.wg is not None:
            self.wg.copy_(dense_init(generator, d, f, self.wg.dtype))
        return self


def mlp_init(generator: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> MlpParams:
    return MlpParams(cfg, generator.device, d_ff).init_(generator)


def mlp_apply(p: MlpParams, x: torch.Tensor, kind: str,
              mesh=None) -> torch.Tensor:
    """The feed-forward of ``x [..., D]``.  Over a mesh whose ``model``
    axis splits ``d_ff``, column-parallel ``wi``/``wg`` and row-parallel
    ``wo`` (the partial products summed over ``model``); the weights are
    gathered over the FSDP axes."""
    tp = is_tp(p.wi) and mesh is not None and mesh.shape["model"] > 1
    grp = mesh.group("model") if tp else None
    xin = copy_to(x, grp) if tp else x
    h = xin @ weight(p.wi, mesh, x.dtype)
    if kind == "swiglu":
        g = xin @ weight(p.wg, mesh, x.dtype)
        h = F.silu(g.float()).to(x.dtype) * h
    elif kind == "sq_relu":
        h = torch.square(F.relu(h.float())).to(x.dtype)
    elif kind == "gelu":
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(kind)
    y = h @ weight(p.wo, mesh, x.dtype)
    return reduce(y, grp) if tp else y
