"""SeamlessM4T-large-v2 — enc-dec multimodal backbone [arXiv:2308.11596].

Transformer backbone only: the speech frontend (mel + conformer feature
extractor) is a stub providing precomputed frame embeddings
(``models/frontends.py``).
"""
import dataclasses

from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type="encdec",
    num_layers=24,                 # decoder
    num_encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,               # MHA (GQA kv=16 == heads)
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    frontend="audio",
    num_frontend_tokens=4096,      # encoder frames (stub embeddings)
    tie_embeddings=True,
    citation="arXiv:2308.11596 (SeamlessM4T v2)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, num_encoder_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        num_frontend_tokens=16)
