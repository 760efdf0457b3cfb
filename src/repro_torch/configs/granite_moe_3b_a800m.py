"""Granite-3.0 MoE 3B-A800M — 40 experts top-8
[hf:ibm-granite/granite-3.0-3b-a800m-base family]."""
import dataclasses

from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=0,
    vocab_size=49155,
    num_experts=40,
    top_k=8,
    expert_d_ff=512,
    tie_embeddings=True,
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base (Granite 3.0 MoE)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        head_dim=32, vocab_size=512, num_experts=4, top_k=2, expert_d_ff=128)
