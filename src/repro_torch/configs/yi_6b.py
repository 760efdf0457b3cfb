"""Yi-6B — llama-architecture dense decoder with GQA [arXiv:2403.04652]."""
import dataclasses

from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    tie_embeddings=False,
    citation="arXiv:2403.04652 (Yi: Open Foundation Models by 01.AI)",
)


def reduced() -> ModelConfig:
    """Same family, smoke-test scale (2L, d_model<=512)."""
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        head_dim=32, d_ff=512, vocab_size=512)
