"""The LM substrate: attention decoders, dense and mixture-of-experts,
the sub-quadratic RWKV-6 and Hymba, and Whisper's encoder-decoder
(training's loss, prefill and greedy decode against a preallocated
cache), mirroring the JAX package's
``repro.models`` module by module (``config``, ``layers``, ``mlp``,
``moe``, ``attention``, ``linear_attn``, ``rwkv``, ``ssm``,
``transformer``, ``model``, ``pspec``), plus ``convert`` for carrying the
JAX package's weights across."""

from .config import (ModelConfig, ShapeConfig, SHAPES, SUBQUADRATIC,
                     shape_cells)
from .model import LM, EncDecLM, build_model
from .moe import MoeParams, moe_apply, moe_init

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "SUBQUADRATIC",
           "shape_cells", "LM", "EncDecLM", "build_model", "MoeParams",
           "moe_apply", "moe_init"]
