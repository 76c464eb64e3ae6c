"""Snowflake Arctic 480B: MoE 128 experts top-2 with a dense residual MLP in
parallel [hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe", n_layers=35, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=4864, vocab=32000,
    block="moe", mlp="swiglu", rope="rope",
    n_experts=128, top_k=2, dense_residual=True,
    opt_state_dtype="bfloat16", microbatch=8,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=48, vocab=384, n_experts=8,
                          top_k=2, microbatch=1)
