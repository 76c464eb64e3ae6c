"""Qwen2.5-3B: dense GQA (kv=2) with QKV bias [hf:Qwen/Qwen2.5]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense", n_layers=36, d_model=2048,
    n_heads=16, n_kv_heads=2, d_ff=11008, vocab=151936,
    block="attn", mlp="swiglu", qkv_bias=True, rope="rope",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab=384)
