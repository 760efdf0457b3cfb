"""Gemma-2 27B — dense, local/global alternating attention, logit softcap
[arXiv:2408.00118]."""
import dataclasses

from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    arch_type="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    sliding_window=4096,           # local layers
    window_pattern=2,              # every 2nd layer global
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norm=True,
    activation="gelu",
    tie_embeddings=True,
    citation="arXiv:2408.00118 (Gemma 2)",
)


def reduced() -> ModelConfig:
    """Same family, smoke-test scale (2L, d_model<=512, window 16)."""
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=8, num_kv_heads=4,
        head_dim=32, d_ff=512, vocab_size=512, sliding_window=16)
