"""Phi-3-mini 3.8B — dense decoder, RoPE + SwiGLU + GQA [arXiv:2404.14219]."""
import dataclasses

from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,               # per assignment: GQA kv=32 (== MHA)
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    tie_embeddings=False,
    citation="arXiv:2404.14219 (Phi-3 Technical Report)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=8, num_kv_heads=8,
        head_dim=32, d_ff=512, vocab_size=512)
