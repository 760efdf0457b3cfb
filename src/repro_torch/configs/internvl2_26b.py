"""InternVL2-26B — InternViT + InternLM2 VLM [arXiv:2404.16821].

LLM backbone only (InternLM2-20B-style decoder); the InternViT-6B vision
encoder + MLP projector is a stub providing precomputed patch embeddings
(``models/frontends.py``).
"""
import dataclasses

from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    arch_type="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    frontend="vision",
    num_frontend_tokens=256,       # ViT patch tokens per image
    tie_embeddings=False,
    citation="arXiv:2404.16821 (InternVL 1.5/2 report)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        head_dim=32, d_ff=512, vocab_size=512, num_frontend_tokens=8)
