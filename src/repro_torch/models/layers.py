"""Primitive layers: norms, projections, embeddings, RoPE.

The JAX package's ``repro.models.layers`` for the serving and training
paths.  Weights keep the JAX layout: a projection is ``[d_in, d_out]`` and
is applied as ``x @ w`` (not ``nn.Linear``'s ``[d_out, d_in]``), so
weights carry across unchanged.  ``*_init`` functions draw from an explicit
``torch.Generator`` on the device the weights live on; apply functions are
plain functions on tensors.  ``rms_norm`` has the JAX package's
hand-written backward (:class:`RmsNorm`).  Over a training mesh a
parameter holds its shard (``spec_of``): :func:`weight` gathers it over
the FSDP axes before use, and the embedding and the tied head are
vocab-parallel over ``model``.  :func:`apply_mrope` is Qwen2-VL's
multimodal RoPE; :func:`sinusoidal_positions` is Whisper's fixed table.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..parallel.collectives import copy_to, gather, reduce
from ..parallel.mesh import spec_of


def parameter(shape: Sequence[int], dtype: torch.dtype,
              device: torch.device, trainable: bool = False) -> nn.Parameter:
    """An uninitialised weight; it takes a gradient only if ``trainable``
    (training), not for serving."""
    return nn.Parameter(torch.empty(tuple(shape), dtype=dtype, device=device),
                        requires_grad=trainable)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, scale: Optional[float] = None
               ) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in float32 (``scale`` defaults to
    ``d_in ** -0.5``) as a ``[d_in, d_out]`` weight of ``dtype``."""
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return w.mul_(scale).to(dtype)      # in place: one float32 copy at most


def embed_init(generator: torch.Generator, vocab: int, d_model: int,
               dtype: torch.dtype) -> torch.Tensor:
    return dense_init(generator, vocab, d_model, dtype, scale=d_model ** -0.5)


class RmsNorm(torch.autograd.Function):
    """RMSNorm with the JAX package's hand-written VJP (``_rms_fwd``,
    ``_rms_bwd``): the forward saves only ``x`` (its own dtype), ``scale``
    and ``r = rsqrt(mean(x^2) + eps)`` (float32, one per row), and the
    backward gives ``dx`` in ``x``'s dtype from one expression and
    ``dscale`` summed in float32 over every leading axis, in ``scale``'s
    dtype."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
        x32 = x.float()
        r = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
        ctx.save_for_backward(x, scale, r)
        return ((x32 * r) * scale.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, scale, r = ctx.saved_tensors
        x32, g32 = x.float(), g.float()
        gw = g32 * scale.float()
        mean_gx = (gw * x32).mean(dim=-1, keepdim=True)
        dx = (gw * r - x32 * (r * r * r) * mean_gx).to(x.dtype)
        dscale = (g32 * x32 * r).reshape(-1, x.shape[-1]).sum(dim=0).to(
            scale.dtype)
        return dx, dscale, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32, returned in ``x``'s dtype (:class:`RmsNorm`)."""
    return RmsNorm.apply(x, scale, eps)


# ------------------------------------------------- sharded weights ------

def is_tp(p: torch.Tensor) -> bool:
    """The parameter is split over ``model`` (tensor-parallel)."""
    return any(axes == "model" for axes in spec_of(p) or ())


def model_group(mesh):
    """The ``model`` axis's process group on a mesh where it holds more
    than one rank, else ``None``."""
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    return mesh.group("model")


def weight(p: torch.Tensor, mesh=None,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A parameter as a product uses it: its shard gathered over the FSDP
    axes on every dim they split (the backward reduce-scatters the
    gradient back to the shard), in ``dtype``.  Its ``model`` split stays:
    the product is tensor-parallel."""
    if mesh is not None:
        for dim, axes in enumerate(spec_of(p) or ()):
            if axes is None or axes == "model":
                continue
            for axis in reversed((axes,) if isinstance(axes, str) else axes):
                p = gather(p, dim, mesh.group(axis), "sum")
    return p if dtype is None else p.to(dtype)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """``table[ids]``.  Over a mesh whose ``model`` axis splits the vocab,
    each rank looks up the ids in its vocab range (zeros for the others)
    and the ranks' rows are summed over ``model``."""
    w = weight(table, mesh)
    if mesh is None or not is_tp(table):
        return w[ids]
    v_local = w.shape[0]
    local = ids.long() - mesh.coords["model"] * v_local
    ok = (local >= 0) & (local < v_local)
    rows = w[local.clamp(0, v_local - 1)] * ok[..., None].to(w.dtype)
    return reduce(rows, mesh.group("model"))


def tied_logits(table: torch.Tensor, x: torch.Tensor,
                fp32: bool = True, mesh=None) -> torch.Tensor:
    """Output head tied to the embedding ``[V, D]``; in float32 (a float32
    copy of the table) when ``fp32``.  Over a mesh whose ``model`` axis
    splits the vocab, this rank's logits ``[..., V / tp]`` (vocab-parallel:
    the backward sums ``x``'s gradient over ``model``)."""
    w = weight(table, mesh)
    w = w.float() if fp32 else w
    if mesh is not None and is_tp(table):
        x = copy_to(x, mesh.group("model"))
    return x.to(w.dtype) @ w.T


# ------------------------------------------------------------------- RoPE ---

def rope_freqs(hd: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] int32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # [hd/2]
    ang = positions[..., None].float() * freqs                     # [B,S,hd/2]
    cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mrope_bounds(hd: int, sections: Tuple[int, ...] = (2, 1, 1)
                 ) -> Tuple[int, ...]:
    """Where each id stream's frequencies end in the rotary spectrum of
    ``hd / 2``: ``sections`` in proportion, rounded down, the last
    stream to the end (at hd 128 and ``(2, 1, 1)``: 32, 48, 64)."""
    half, tot = hd // 2, sum(sections)
    bounds, acc = [], 0
    for sec in sections:
        acc += (half * sec) // tot
        bounds.append(acc)
    bounds[-1] = half
    return tuple(bounds)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, ...] = (2, 1, 1)) -> torch.Tensor:
    """M-RoPE (Qwen2-VL): x [B, S, H, hd]; positions [3, B, S] int32, the
    (temporal, height, width) ids.  The rotary spectrum is split over the
    three id streams in proportion to ``sections`` (:func:`mrope_bounds`);
    with all three streams equal it is :func:`apply_rope`."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                      # [hd/2]
    parts, start = [], 0
    for i, end in enumerate(mrope_bounds(hd, sections)):
        parts.append(positions[i][..., None].float() * freqs[start:end])
        start = end
    ang = torch.cat(parts, dim=-1)                               # [B,S,hd/2]
    cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d_model: int,
                         device: Optional[torch.device] = None
                         ) -> torch.Tensor:
    """Fixed sinusoidal table ``[seq, d_model]`` float32 (Whisper's
    encoder and decoder): ``sin`` on the even columns, ``cos`` on the odd
    ones, of ``pos / 10000 ** (dim / d_model)`` for ``dim`` the even
    column."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=device)[None, :]
    ang = pos / (10000.0 ** (dim / d_model))
    out = torch.zeros((seq, d_model), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out
