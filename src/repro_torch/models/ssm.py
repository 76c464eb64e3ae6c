"""Mamba-2/SSD-style selective-state-space heads for Hymba; the JAX
package's ``repro.models.ssm``.

A scalar decay per head (state ``N = cfg.ssm_state`` key channels), so the
sequence mix is the chunked linear attention shared with RWKV, with ``C``
as the query, ``B`` as the key, the value scaled by the time step and no
bonus; O(1)-state decode.  As in the reference, Mamba's depthwise
convolution is left out.  These run on one device: Hymba over a training
mesh is ROADMAP item 14.5.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import dense_init, parameter
from .linear_attn import chunked_linear_attention, linear_attention_decode


def _dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    h = cfg.ssm_heads
    hd = cfg.hd
    return h, hd, h * hd     # heads, head value dim, inner dim


class SsmParams(nn.Module):
    """``w_in``/``w_gate`` [D, dI] (the value path and its silu gate),
    ``w_bc`` [D, 2N*H] (B and C per head), ``w_dt`` [D, H] (float32),
    ``a_log`` [H] and ``d_skip`` [dI] (float32), ``w_out`` [dI, D]; the
    projections in the param dtype, uninitialised until :meth:`init_`;
    trainable weights take gradients."""

    FIELDS = ("w_in", "w_gate", "w_bc", "w_dt", "a_log", "d_skip", "w_out")

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 trainable: bool = False):
        super().__init__()
        d, n = cfg.d_model, cfg.ssm_state
        h, _, di = _dims(cfg)
        dt, f32 = cfg.p_dtype(), torch.float32
        shapes = dict(w_in=((d, di), dt), w_gate=((d, di), dt),
                      w_bc=((d, 2 * n * h), dt), w_dt=((d, h), f32),
                      a_log=((h,), f32), d_skip=((di,), f32),
                      w_out=((di, d), dt))
        for name in self.FIELDS:
            shape, dtype = shapes[name]
            setattr(self, name, parameter(shape, dtype, device, trainable))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "SsmParams":
        """``ssm_init``'s values: ``a_log`` 0, ``d_skip`` 1, the
        projections ``N(0, 1)`` scaled by ``d_in**-0.5``, drawn in
        float32."""
        for name in ("w_in", "w_gate", "w_bc", "w_dt", "w_out"):
            w = getattr(self, name)
            w.copy_(dense_init(generator, *w.shape, w.dtype))
        self.a_log.zero_()
        self.d_skip.fill_(1.0)
        return self


def ssm_init(generator: torch.Generator, cfg: ModelConfig) -> SsmParams:
    return SsmParams(cfg, generator.device).init_(generator)


def _project(p: SsmParams, x: torch.Tensor, cfg: ModelConfig):
    """``x [..., D]`` -> ``(v [..., H, hd]`` float32 scaled by ``dt``,
    ``B``, ``C [..., H, N]`` float32, ``logw [..., H]``, ``xv``,
    ``gate)``."""
    lead = x.shape[:-1]
    n = cfg.ssm_state
    h, hd, _ = _dims(cfg)
    xv = x @ p.w_in.to(x.dtype)
    gate = x @ p.w_gate.to(x.dtype)
    bc = (x @ p.w_bc.to(x.dtype)).float().reshape(lead + (h, 2 * n))
    bmat, cmat = bc[..., :n], bc[..., n:]
    dt = F.softplus(x.float() @ p.w_dt)                  # [.., H]
    logw = dt * -torch.exp(p.a_log)                      # [.., H] < 0
    v = xv.reshape(lead + (h, hd)).float() * dt[..., None]
    return v, bmat, cmat, logw, xv, gate


def _skip_gate_out(p: SsmParams, o: torch.Tensor, xv: torch.Tensor,
                   gate: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``(o + xv * d_skip)`` (float32) in ``dtype``, gated by
    ``silu(gate)``, through ``w_out``."""
    y = o + xv.float() * p.d_skip
    y = y.to(dtype) * F.silu(gate.float()).to(dtype)
    return y @ p.w_out.to(dtype)


def ssm_apply(p: SsmParams, x: torch.Tensor, cfg: ModelConfig,
              state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], state [B, H, N, hd] float32)."""
    b, s, _ = x.shape
    n = cfg.ssm_state
    h, _, di = _dims(cfg)
    v, bmat, cmat, logw, xv, gate = _project(p, x, cfg)
    logw_k = logw[..., None].expand(b, s, h, n)
    o, s1 = chunked_linear_attention(cmat, bmat, v, logw_k, u=None,
                                     chunk=64, state0=state)
    return _skip_gate_out(p, o.reshape(b, s, di), xv, gate, x.dtype), s1


def ssm_decode(p: SsmParams, x1: torch.Tensor, cfg: ModelConfig,
               state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x1 [B, D]; state [B, H, N, hd] -> (y [B, D], new state)."""
    b = x1.shape[0]
    n = cfg.ssm_state
    h, _, di = _dims(cfg)
    v, bmat, cmat, logw, xv, gate = _project(p, x1, cfg)
    o, s1 = linear_attention_decode(cmat, bmat, v,
                                    logw[..., None].expand(b, h, n), state,
                                    u=None)
    return _skip_gate_out(p, o.reshape(b, di), xv, gate, x1.dtype), s1
