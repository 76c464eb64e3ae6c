"""The LM substrate's serving path: a dense attention decoder (prefill and
greedy decode against a preallocated KV cache), mirroring the JAX
package's ``repro.models`` module by module (``config``, ``layers``,
``mlp``, ``attention``, ``transformer``, ``model``), plus ``convert`` for
carrying the JAX package's weights across."""

from .config import ModelConfig, ShapeConfig, SHAPES, SUBQUADRATIC
from .model import LM, build_model

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "SUBQUADRATIC", "LM",
           "build_model"]
