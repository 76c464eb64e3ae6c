"""Mistral-Nemo-12B: dense GQA, 128k context, head_dim 128 != d_model/heads
[hf:mistralai/Mistral-Nemo-Base-2407]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=131072,
    block="attn", head_dim=128, mlp="swiglu", rope="rope",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=80, n_heads=4, n_kv_heads=2,
                          head_dim=24, d_ff=160, vocab=384)
