"""Feed-forward variants: SwiGLU (llama-family), squared-ReLU (nemotron,
rwkv channel-mix), GELU (whisper); the JAX package's ``repro.models.mlp``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import dense_init, parameter


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


def mlp_apply(p: MlpParams, x: torch.Tensor, kind: str) -> torch.Tensor:
    h = x @ p.wi.to(x.dtype)
    if kind == "swiglu":
        g = x @ p.wg.to(x.dtype)
        h = F.silu(g.float()).to(x.dtype) * h
    elif kind == "sq_relu":
        h = torch.square(F.relu(h.float())).to(x.dtype)
    elif kind == "gelu":
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(kind)
    return h @ p.wo.to(x.dtype)
