"""Qwen3-30B-A3B: MoE, 128 experts top-8, per-expert d_ff=768
[hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=4, d_ff=768, vocab=151936,
    block="moe", head_dim=128, mlp="swiglu", rope="rope",
    n_experts=128, top_k=8,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=32, vocab=384, n_experts=8,
                          top_k=2)
