"""Mamba2-370M — attention-free SSM with state-space duality
[arXiv:2405.21060]."""
import dataclasses

from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,                   # attention-free
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,                        # no MLP (mamba2 blocks are mixer-only)
    vocab_size=50280,
    ssm_state=128,                 # N
    ssm_heads=32,                  # H (d_inner 2048 / P 64)
    ssm_head_dim=64,               # P
    ssm_expand=2,
    conv_kernel=4,
    tie_embeddings=True,
    citation="arXiv:2405.21060 (Transformers are SSMs: Mamba-2 / SSD)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=128, ssm_heads=4, ssm_head_dim=32,
        ssm_state=16, vocab_size=512)
