"""Plain PyTorch versions of the port's kernels.

Each is the CPU path of its kernel's wrapper and the yardstick the card's
kernel is held against.  Counterpart of ``repro/kernels/ref.py``.
"""
from __future__ import annotations

import torch

__all__ = ["dense_ref"]


def dense_ref(x, w, b=None, activation: str = "none"):
    """Fused dense: x @ w (+ b) (+ activation); x may carry leading dims."""
    out = x @ w.to(x.dtype)
    if b is not None:
        out = out + b.to(out.dtype)
    if activation == "relu":
        out = torch.relu(out)
    elif activation != "none":
        raise ValueError(activation)
    return out
