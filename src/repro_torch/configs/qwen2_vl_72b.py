"""Qwen2-VL-72B backbone: dense GQA decoder with M-RoPE; the vision frontend
is a stub — input_specs() supplies patch embeddings [arXiv:2409.12191]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=29568, vocab=152064,
    block="attn", mlp="swiglu", rope="mrope", embeds_input=True,
    opt_state_dtype="bfloat16", microbatch=8,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab=384, microbatch=1)
