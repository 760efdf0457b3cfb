"""Hymba-1.5B — hybrid parallel attention + mamba heads [arXiv:2411.13676].

Each block runs GQA attention and an SSD mixer *in parallel* on the same
input, with per-branch output norms and learned mixing (models/blocks.py).
Meta-tokens are omitted (prompt-side trick, not a backbone property).
Per the Hymba recipe, most layers use sliding-window attention; first,
middle and last layers stay global.
"""
import dataclasses

from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_heads=25,
    ssm_head_dim=128,              # d_inner = 3200 = 2 * d_model
    ssm_expand=2,
    conv_kernel=4,
    sliding_window=1024,
    global_layers=(0, 15, 31),     # full-attention layers
    tie_embeddings=True,
    citation="arXiv:2411.13676 (Hymba: Hybrid-head Architecture)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        head_dim=32, d_ff=512, vocab_size=512, ssm_heads=4, ssm_head_dim=32,
        ssm_state=16, sliding_window=16, global_layers=(0,))
