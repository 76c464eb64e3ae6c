"""Flash-attention forward (K6): the prefill's attention over a sequence.

    out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, hk] * hd^-0.5) @ v[b, j, hk]

``q`` is ``[B, Sq, H, hd]`` and ``k``/``v`` are ``[B, Skv, Hkv, hd]`` with
``Hkv`` dividing ``H``: query head ``h`` reads KV head ``h // (H // Hkv)``,
the grouping of the model's chunked attention.  With ``causal`` the mask
keeps key ``j <= i``, both counted from 0; with ``q_offset`` query row
``i`` stands at position ``q_offset + i`` and keeps key ``j <= q_offset +
i`` (a shard of the sequence-parallel route: ``block_attention``'s
``q_offset``).  Masked logits are ``-1e30``.
The softmax runs in float32, the probabilities are rounded to ``v``'s
dtype before the product with ``v`` (float32 accumulation), the output is
divided by ``max(l, 1e-30)`` and has ``q``'s dtype.  There are no padded
keys: every key below ``Skv`` counts and no other does, causal or not.

The CUDA kernels are in ``csrc/attention.cu``: a Hopper kernel (TMA,
``wgmma``, warp specialisation) for bf16 with ``hd == 128``, ``mma.sync``
for bf16 with ``hd`` in {16, 32, 64, 192, 256}, a CUDA-core kernel for the
rest up to ``hd == SLICE_HD`` (float32 at any such ``hd``), and above it
the same CUDA-core kernel with the head dim streamed in slices
(:func:`head_slices`); :func:`flash_attention_route` names the one a call
takes.  The plain
version below computes the same function in float32 chunks of query rows,
so a ``[B, H, Sq, Skv]`` score matrix is never held whole;
:mod:`repro_torch.kernels.ops` routes between it and the kernels.

The backward (:func:`flash_attention_backward`) has no kernel: no Pallas
kernel of the JAX package has one, and the reference's gradient is XLA's
autodiff of ``block_attention``'s query blocks, each rematerialised under
``jax.checkpoint``.  It recomputes the scores one chunk of query rows at a
time in float32 (the same memory profile) with plain matrix products.
"""

from __future__ import annotations

import torch

from . import build

#: query rows per chunk of the plain version
PLAIN_CHUNK = 512
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the C entry's route codes (``flash_attention_route`` in attention.cu)
ROUTES = ("cuda-core", "mma.sync", "wgmma", "sliced")
#: the widest head dim the unsliced CUDA-core kernel takes, and the widest
#: slice of the sliced one (``kMaxSimtHD`` in attention.cu)
SLICE_HD = 512


def head_slices(hd: int):
    """The output column slices ``[(start, width), ...]`` of the sliced
    route at head dim ``hd`` (above ``SLICE_HD``): ``hd`` cut into
    ``ceil(hd / SLICE_HD)`` equal parts, each rounded up to a multiple of
    32, the last holding what is left (``sliced_width`` in attention.cu).
    Each score sums over Q/K slices of ``SLICE_HD`` dims in turn."""
    parts = -(-hd // SLICE_HD)
    per = -(-hd // parts)
    width = -(-per // 32) * 32
    return [(c0, min(width, hd - c0)) for c0 in range(0, hd, width)]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, chunk: int = PLAIN_CHUNK,
                          q_offset: int = 0) -> torch.Tensor:
    b, sq, h, hd = q.shape
    skv, hk = k.shape[1], k.shape[2]
    g = h // hk
    out = torch.empty_like(q)
    if skv == 0:
        return out.zero_()
    kt = k.float().permute(0, 2, 3, 1)[:, :, None]           # [B,Hkv,1,hd,S]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]           # [B,Hkv,1,S,hd]
    k_pos = torch.arange(skv, device=q.device)
    for s0 in range(0, sq, chunk):
        c = min(chunk, sq - s0)
        qc = (q[:, s0:s0 + c].float().reshape(b, c, hk, g, hd)
              .permute(0, 2, 3, 1, 4))                        # [B,Hkv,G,c,hd]
        logits = torch.matmul(qc, kt) * hd ** -0.5            # [B,Hkv,G,c,S]
        if causal:
            q_pos = torch.arange(q_offset + s0, q_offset + s0 + c,
                                 device=q.device)
            logits.masked_fill_(q_pos[:, None] < k_pos[None, :], -1e30)
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp(logits - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p.to(v.dtype).float(), vf) / l.clamp_min(1e-30)
        out[:, s0:s0 + c] = (o.permute(0, 3, 1, 2, 4).reshape(b, c, h, hd)
                             .to(q.dtype))
    return out


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, dout: torch.Tensor,
                             causal: bool = True, chunk: int = PLAIN_CHUNK,
                             q_offset: int = 0):
    """Gradients ``(dq, dk, dv)`` of the attention above at ``q, k, v`` for
    the output gradient ``dout`` (``q``'s shape), each in its input's dtype.

    One chunk of query rows at a time, in float32: the scores and the
    normalised probabilities ``p`` are recomputed, the probabilities that
    multiply ``v`` are rounded to ``v``'s dtype as in the forward
    (``dv = round(p)^T dout``), ``dp = dout v^T``, ``ds = p (dp -
    rowsum(p dp))``, ``dq = ds k hd^-0.5``, ``dk = ds^T q hd^-0.5``; ``dk``
    and ``dv`` are summed over each KV head's group of query heads, and
    accumulate over the chunks in float32.  The ``[B, H, Sq, Skv]`` matrix
    is never held whole."""
    b, sq, h, hd = q.shape
    skv, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = hd ** -0.5
    dq = torch.empty_like(q)
    dk = torch.zeros((b, hk, skv, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]            # [B,Hkv,1,S,hd]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    k_pos = torch.arange(skv, device=q.device)

    def rows(t, s0, c):                                        # [B,Hkv,G,c,hd]
        return (t[:, s0:s0 + c].float().reshape(b, c, hk, g, hd)
                .permute(0, 2, 3, 1, 4))

    for s0 in range(0, sq, chunk):
        c = min(chunk, sq - s0)
        qc, doc = rows(q, s0, c), rows(dout, s0, c)
        logits = torch.matmul(qc, kf.transpose(-1, -2)) * scale
        if causal:
            q_pos = torch.arange(q_offset + s0, q_offset + s0 + c,
                                 device=q.device)
            logits.masked_fill_(q_pos[:, None] < k_pos[None, :], -1e30)
        p = torch.softmax(logits, dim=-1)                      # [B,Hkv,G,c,S]
        del logits
        dv += torch.einsum("bhgcs,bhgcd->bhsd", p.to(v.dtype).float(), doc)
        dp = torch.matmul(doc, vf.transpose(-1, -2))
        ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
        del p, dp
        dq[:, s0:s0 + c] = ((torch.matmul(ds, kf) * scale)
                            .permute(0, 3, 1, 2, 4).reshape(b, c, h, hd)
                            .to(q.dtype))
        dk += torch.einsum("bhgcs,bhgcd->bhsd", ds, qc) * scale
    return (dq, dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, q_offset: int = 0) -> torch.Tensor:
    b, sq, h, hd = q.shape
    skv, hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    rc = build.load().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv,
        h, hk, hd, int(causal), int(q_offset), _DTYPE_CODES[q.dtype],
        hd ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed (cudaError {rc})")
    return out


def flash_attention_route(dtype: torch.dtype, hd: int) -> str:
    """The CUDA kernel that :func:`flash_attention_cuda` launches for
    ``dtype`` and head dim ``hd``, as the C entry decides (loads, and if
    need be builds, the kernels)."""
    code = build.load().flash_attention_route(hd, _DTYPE_CODES[dtype])
    if code < 0:
        raise ValueError(f"flash_attention: no kernel for {dtype}, hd {hd}")
    return ROUTES[code]
