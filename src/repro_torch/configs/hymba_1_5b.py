"""Hymba-1.5B: hybrid heads — attention and Mamba-style SSM heads run in
parallel within each block [arXiv:2411.13676]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, d_ff=5504, vocab=32001,
    block="hymba", head_dim=64, mlp="swiglu", rope="rope",
    ssm_state=16, ssm_heads=25,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab=256, ssm_heads=4)
