"""The four assigned input-shape presets, from ``repro/configs/shapes.py``."""
from repro_torch.core.types import ShapeConfig

SHAPES = {
    "train_4k": ShapeConfig("train_4k", seq_len=4_096, global_batch=256,
                            mode="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32,
                               mode="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32_768, global_batch=128,
                              mode="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524_288, global_batch=1,
                             mode="decode"),
}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
