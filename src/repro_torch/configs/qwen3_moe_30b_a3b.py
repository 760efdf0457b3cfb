"""Qwen3-30B-A3B — MoE decoder, 128 experts top-8, QK-norm
[hf:Qwen/Qwen3-30B-A3B]."""
import dataclasses

from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,                        # every FFN is MoE
    vocab_size=151936,
    num_experts=128,
    top_k=8,
    expert_d_ff=768,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    citation="hf:Qwen/Qwen3-30B-A3B (Qwen3 model card)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        head_dim=32, vocab_size=512, num_experts=4, top_k=2, expert_d_ff=128)
