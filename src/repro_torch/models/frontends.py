"""Stub modality front ends, from ``repro/models/frontends.py``.

The ``vlm`` and ``audio`` architectures specify the transformer backbone
only: the ViT/SigLIP encoder (vision) and the mel-spectrogram/conv feature
extractor (audio) are stubs that provide *precomputed* patch/frame
embeddings of the right shape.  These helpers give that shape and random
stand-ins for it.
"""
from __future__ import annotations

import torch

from repro_torch.core.device import resolve_device

__all__ = ["frontend_embed_shape", "random_frontend_embeds"]


def frontend_embed_shape(cfg, batch: int):
    """(B, P, d_model) for P front-end tokens (patches or audio frames),
    or None for a config without a front end."""
    if not cfg.frontend:
        return None
    return (batch, cfg.num_frontend_tokens, cfg.d_model)


def random_frontend_embeds(generator, cfg, batch: int, dtype=torch.bfloat16,
                           device="cuda"):
    """N(0, 1) x 0.02 embeddings of ``frontend_embed_shape`` in ``dtype``,
    drawn from ``generator`` on ``device`` (``"cuda"`` by default, which
    raises without a card unless ``"cpu"`` is passed); None without a
    front end."""
    shape = frontend_embed_shape(cfg, batch)
    if shape is None:
        return None
    dev = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        raise TypeError("random_frontend_embeds needs an explicit "
                        "torch.Generator")
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=dev) * 0.02
