"""RWKV-6 (Finch) 1.6B: attention-free, data-dependent decay linear
attention [arXiv:2404.05892]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=7168, vocab=65536,
    block="rwkv", rwkv_head_dim=64, mlp="sq_relu", rope="none",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab=256, rwkv_head_dim=16)
