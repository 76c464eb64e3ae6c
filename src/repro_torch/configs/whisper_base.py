"""Whisper-base: encoder-decoder; the conv/audio frontend is a stub —
input_specs() supplies 1500 precomputed frame embeddings [arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio", n_layers=6, d_model=512,
    n_heads=8, n_kv_heads=8, d_ff=2048, vocab=51865,
    block="attn", mlp="gelu", rope="none",
    enc_dec=True, enc_layers=6, enc_frames=1500, embeds_input=False,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, enc_layers=2, d_model=64, n_heads=4,
                          n_kv_heads=4, head_dim=16, d_ff=128, vocab=384,
                          enc_frames=64)
