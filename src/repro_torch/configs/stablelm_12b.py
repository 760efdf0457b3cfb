"""StableLM-2-12B — dense decoder with GQA
[hf:stabilityai/stablelm-2-1_6b family / stablelm-2-12b]."""
import dataclasses

from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,                  # d_model / num_heads
    d_ff=13824,
    vocab_size=100352,
    tie_embeddings=False,
    citation="hf:stabilityai/stablelm-2-12b (model card)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        head_dim=32, d_ff=512, vocab_size=512)
