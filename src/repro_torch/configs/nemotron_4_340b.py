"""Nemotron-4-340B: dense GQA with squared-ReLU MLP [arXiv:2402.16819]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense", n_layers=96, d_model=18432,
    n_heads=96, n_kv_heads=8, d_ff=73728, vocab=256000,
    block="attn", mlp="sq_relu", rope="rope",
    # 340B params: bf16 Adam moments keep optimizer state within v5e HBM
    opt_state_dtype="bfloat16", microbatch=16,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
                          head_dim=16, d_ff=384, vocab=512, microbatch=1)
