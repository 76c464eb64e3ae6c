"""Model and shape configuration (the JAX package's ``repro.models.config``,
with ``torch`` dtypes).

One :class:`ModelConfig` describes any architecture in the assigned pool —
dense / MoE / VLM / SSM / hybrid / encoder-decoder — through the ``block``
field plus family-specific knobs.  Performance levers that the §Perf
hillclimb iterates on (attention chunk size, MoE capacity factor, remat
policy, optimizer state dtype, logits sharding) are explicit fields so every
experiment is a config diff.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | vlm | ssm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    block: str = "attn"            # attn | moe | rwkv | hymba
    head_dim: Optional[int] = None # defaults to d_model // n_heads
    mlp: str = "swiglu"            # swiglu | sq_relu | gelu
    qkv_bias: bool = False
    rope: str = "rope"             # rope | mrope | none
    rope_theta: float = 1e6

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    dense_residual: bool = False   # arctic: dense MLP in parallel with MoE
    capacity_factor: float = 1.25
    moe_impl: str = "ep"           # ep (shard_map expert-parallel) | spmd

    # --- RWKV / SSM ---
    ssm_state: int = 16
    rwkv_head_dim: int = 64
    ssm_heads: int = 0             # hymba parallel mamba heads

    # --- encoder-decoder (whisper) ---
    enc_dec: bool = False
    enc_layers: int = 0
    enc_frames: int = 1500         # stub frontend output length

    # --- modality frontend stub (vlm / audio): inputs are embeddings ---
    embeds_input: bool = False

    # --- numerics / perf levers ---
    dtype: str = "bfloat16"        # activation dtype
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    attn_chunk: int = 512          # query-block size for chunked attention
    remat: bool = True
    scan_layers: bool = True
    microbatch: int = 1            # gradient-accumulation steps
    logits_fp32: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.block == "moe"

    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def p_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # parameter count (for MODEL_FLOPS = 6*N*D roofline term)
    def param_count(self, active_only: bool = False) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab
        hq, hk, hd = self.n_heads, self.n_kv_heads, self.hd
        def attn_p():
            return d * hq * hd + 2 * d * hk * hd + hq * hd * d
        def mlp_p(ff):
            return d * ff * (3 if self.mlp == "swiglu" else 2)
        per_layer = 0
        if self.block == "attn":
            per_layer = attn_p() + mlp_p(f) + 2 * d
        elif self.block == "moe":
            ne = (self.top_k if active_only else self.n_experts)
            per_layer = attn_p() + ne * mlp_p(f) + 2 * d
            if self.dense_residual:
                per_layer += mlp_p(f)
            per_layer += d * self.n_experts  # router
        elif self.block == "rwkv":
            hr = self.d_model // self.rwkv_head_dim
            per_layer = 6 * d * d + mlp_p(f) + 2 * d   # r,k,v,g,o,decay + channel mix
        elif self.block == "hymba":
            n = self.ssm_state
            ssm = d * (2 * d) + d * (2 * n) + d + d * d   # in/out proj + B,C,dt
            per_layer = attn_p() + ssm + mlp_p(f) + 2 * d
        n_p = self.n_layers * per_layer + v * d + d
        if self.enc_dec:
            enc_per = attn_p() + mlp_p(f) + 2 * d
            cross = attn_p()
            n_p += self.enc_layers * enc_per + self.n_layers * cross
        return int(n_p)


@dataclass(frozen=True)
class ShapeConfig:
    name: str                       # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# archs allowed to run long_500k (sub-quadratic sequence mixing)
SUBQUADRATIC = ("rwkv6-1.6b", "hymba-1.5b")


def shape_cells(arch: str) -> Tuple[str, ...]:
    """The shape cells assigned to an architecture (skip rules per DESIGN.md)."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in SUBQUADRATIC:
        cells.append("long_500k")
    return tuple(cells)
