"""Public kernel entry points of the port, routed by tensor device.

Counterpart of ``repro/kernels/ops.py``.  There is no implementation
switch: a CPU tensor takes the plain version in ``ref.py``, a CUDA tensor
launches the hand-written kernel or raises.  No path gives way to the
plain version on the card.
"""
from __future__ import annotations

import torch

from . import dense as _dense
from . import ref

__all__ = ["dense"]


def dense(x, w, b=None, activation: str = "none"):
    """Fused dense layer: x @ w (+ b) (+ activation).

    ``x`` may carry leading batch dims; they flatten into the kernel's row
    axis and reshape back.  ``w`` is cast to ``x.dtype`` as the reference
    does, and ``b`` enters the f32 epilogue.
    """
    if activation not in _dense.ACTIVATIONS:
        raise ValueError(f"activation must be one of {_dense.ACTIVATIONS}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    w = w.to(x.dtype).contiguous()
    if x.device.type == "cpu":
        out = ref.dense_ref(x2, w, b, activation=activation)
    else:
        if b is not None:
            b = b.to(torch.float32).contiguous()
        out = _dense.dense_cuda(x2, w, b, activation=activation)
    return out.reshape(*lead, w.shape[-1])
