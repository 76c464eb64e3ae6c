"""RWKV-6 (Finch) block: token mix with data-dependent vector decay and a
squared-ReLU channel mix, both with token shift; the JAX package's
``repro.models.rwkv``.

Decode state per layer: the previous token of each shift (the block's
normed input, as the full-sequence mixes return it) and the
``[H, dk, dv]`` wkv state, O(1) in the sequence length.  The "ln_x"
normalisation is an RMS over the whole ``D`` (not per head), as the
reference computes it.  The decay's projection runs in float32.  These run
on one device: RWKV over a training mesh is ROADMAP item 14.5.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import dense_init, parameter
from .linear_attn import chunked_linear_attention, linear_attention_decode

_MUS = ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g")
_PROJ = ("wr", "wk", "wv", "wg", "wo")


class RwkvParams(nn.Module):
    """The reference's 19 fields, in its order and dtypes: the token mix's
    lerp coefficients ``mu_r``/``mu_k``/``mu_v``/``mu_w``/``mu_g`` [D],
    projections ``wr``/``wk``/``wv``/``wg``/``wo`` and the decay's
    ``w_decay`` [D, D], ``decay_base`` [D], ``u_bonus`` [H, hd] and
    ``ln_x`` [D] (these three float32); the channel mix's ``mu_ck``/
    ``mu_cr`` [D], ``ck`` [D, F], ``cv`` [F, D] and ``cr`` [D, D].  The
    rest are in the param dtype; uninitialised until :meth:`init_`;
    trainable weights take gradients."""

    FIELDS = _MUS + _PROJ + ("w_decay", "decay_base", "u_bonus", "ln_x",
                             "mu_ck", "mu_cr", "ck", "cv", "cr")

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 trainable: bool = False):
        super().__init__()
        d, f, hd = cfg.d_model, cfg.d_ff, cfg.rwkv_head_dim
        dt, f32 = cfg.p_dtype(), torch.float32
        shapes = dict.fromkeys(_MUS + ("mu_ck", "mu_cr"), ((d,), dt))
        shapes.update(dict.fromkeys(_PROJ + ("w_decay", "cr"), ((d, d), dt)))
        shapes.update(decay_base=((d,), f32), u_bonus=((d // hd, hd), f32),
                      ln_x=((d,), f32), ck=((d, f), dt), cv=((f, d), dt))
        for name in self.FIELDS:
            shape, dtype = shapes[name]
            setattr(self, name, parameter(shape, dtype, device, trainable))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "RwkvParams":
        """``rwkv_init``'s values: the lerps 0.5, ``decay_base`` -2,
        ``u_bonus`` 0, ``ln_x`` 1; ``N(0, 1)`` scaled by ``d_in**-0.5``
        (``w_decay`` by 0.01, ``cv`` by ``F**-0.5``), drawn in float32."""
        for name in _MUS + ("mu_ck", "mu_cr"):
            getattr(self, name).fill_(0.5)
        for name in _PROJ + ("w_decay", "ck", "cv", "cr"):
            w = getattr(self, name)
            scale = {"w_decay": 0.01, "cv": w.shape[0] ** -0.5}.get(name)
            w.copy_(dense_init(generator, *w.shape, w.dtype, scale=scale))
        self.decay_base.fill_(-2.0)
        self.u_bonus.zero_()
        self.ln_x.fill_(1.0)
        return self


def rwkv_init(generator: torch.Generator, cfg: ModelConfig) -> RwkvParams:
    return RwkvParams(cfg, generator.device).init_(generator)


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros, or ``prev [B, D]``, at t=0).
    x [B, S, D]."""
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _mix(x: torch.Tensor, xs: torch.Tensor, mu: torch.Tensor
         ) -> torch.Tensor:
    return x + (xs - x) * mu.to(x.dtype)


def _decay_logw(p: RwkvParams, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent log-decay in (-inf, 0): ``-exp(base + proj(x))``, the
    projection in float32, clipped to [-8, 4]."""
    raw = p.decay_base + xw.float() @ p.w_decay.float()
    return -torch.exp(torch.clamp(raw, -8.0, 4.0))


def _ln_x_gate(p: RwkvParams, o: torch.Tensor, g: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """The float32 RMS of ``o`` over the whole ``D`` times ``ln_x``, gated
    by ``silu(g)``, in ``dtype``."""
    o32 = o.float()
    o32 = o32 * torch.rsqrt(torch.mean(o32 * o32, -1, keepdim=True) + 1e-6)
    return (o32 * p.ln_x).to(dtype) * F.silu(g.float()).to(dtype)


def rwkv_token_mix(p: RwkvParams, x: torch.Tensor, cfg: ModelConfig,
                   state: Optional[Tuple] = None
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                  torch.Tensor]]:
    """x [B, S, D] -> (out [B, S, D], (x[:, -1], wkv state [B, H, hd,
    hd])); ``state = (prev_x, S)`` continues a sequence."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    prev_x, s0 = (None, None) if state is None else state
    xs = _shift(x, prev_x)
    r, k, v, g = (_mix(x, xs, getattr(p, mu)) @ getattr(p, w).to(x.dtype)
                  for mu, w in (("mu_r", "wr"), ("mu_k", "wk"),
                                ("mu_v", "wv"), ("mu_g", "wg")))
    logw = _decay_logw(p, _mix(x, xs, p.mu_w))
    o, s1 = chunked_linear_attention(
        *(t.reshape(b, s, h, hd) for t in (r, k, v, logw)), u=p.u_bonus,
        chunk=64, state0=s0)
    o = _ln_x_gate(p, o.reshape(b, s, d), g, x.dtype)
    return o @ p.wo.to(x.dtype), (x[:, -1], s1)


def rwkv_channel_mix(p: RwkvParams, x: torch.Tensor,
                     prev_x: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D], x[:, -1])."""
    xs = _shift(x, prev_x)
    k = _mix(x, xs, p.mu_ck) @ p.ck.to(x.dtype)
    k = torch.square(F.relu(k.float())).to(x.dtype)
    kv = k @ p.cv.to(x.dtype)
    rgate = torch.sigmoid((_mix(x, xs, p.mu_cr) @ p.cr.to(x.dtype)).float())
    return rgate.to(x.dtype) * kv, x[:, -1]


def rwkv_token_mix_decode(p: RwkvParams, x1: torch.Tensor, cfg: ModelConfig,
                          state: Tuple[torch.Tensor, torch.Tensor]
                          ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                         torch.Tensor]]:
    """Single-token token mix.  x1 [B, D]; ``state = (prev_x [B, D], S)``;
    returns ``(out [B, D], (x1, S'))``."""
    b, d = x1.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    prev_x, s0 = state
    r, k, v, g = (_mix(x1, prev_x, getattr(p, mu)) @ getattr(p, w).to(
        x1.dtype) for mu, w in (("mu_r", "wr"), ("mu_k", "wk"),
                                ("mu_v", "wv"), ("mu_g", "wg")))
    logw = _decay_logw(p, _mix(x1, prev_x, p.mu_w))
    o, s1 = linear_attention_decode(
        *(t.reshape(b, h, hd) for t in (r, k, v, logw)), s0, u=p.u_bonus)
    o = _ln_x_gate(p, o.reshape(b, d), g, x1.dtype)
    return o @ p.wo.to(x1.dtype), (x1, s1)


def rwkv_channel_mix_decode(p: RwkvParams, x1: torch.Tensor,
                            prev_x: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token channel mix: x1, prev_x [B, D] -> (out [B, D], x1)."""
    out, _ = rwkv_channel_mix(p, x1[:, None], prev_x)
    return out[:, 0], x1
