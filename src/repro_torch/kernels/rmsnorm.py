"""RMSNorm: the wrapper around ``csrc/rmsnorm.cu`` (K9).

Counterpart of ``repro/kernels/rmsnorm.py``.  Forward only, as in the
reference: ``ops.rmsnorm`` calls ``rmsnorm_cuda`` on a CUDA tensor and
``ref.rmsnorm_ref`` on a CPU tensor, and raises where a gradient is
wanted on the card.
"""
from __future__ import annotations

import torch

from . import launch

__all__ = ["rmsnorm_cuda"]

_DTYPES = (torch.bfloat16, torch.float32)


def rmsnorm_cuda(x, scale, eps: float = 1e-6):
    """K9 on the card: x (rows, d) bfloat16 or float32, scale (d,) float32
    or bfloat16, both contiguous on one CUDA device, outside autograd.
    Returns x * rsqrt(mean(x^2) + eps) * scale in x's dtype.
    ``rmsnorm_cuda.launches`` counts the launches."""
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm_cuda takes bfloat16 or float32 x and "
                        f"scale, got {x.dtype} and {scale.dtype}")
    if x.ndim != 2 or scale.shape != (x.shape[1],) or x.numel() == 0:
        raise ValueError(f"rmsnorm_cuda takes x (rows, d) and scale (d,), "
                         f"got {tuple(x.shape)} and {tuple(scale.shape)}")
    if x.shape[0] >= 2**31 or x.shape[1] >= 2**31:
        raise ValueError(f"rmsnorm_cuda: x {tuple(x.shape)} too large")
    for t in (x, scale):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError("rmsnorm_cuda takes tensors on one CUDA device, "
                             f"got {x.device} and {scale.device}")
        if not t.is_contiguous():
            raise ValueError("rmsnorm_cuda takes contiguous tensors")
        if t.requires_grad:
            raise RuntimeError(
                "rmsnorm_cuda is forward only (the reference has no "
                "backward either): call it outside autograd")
    out = torch.empty_like(x)
    rows, d = x.shape
    launch.run("rmsnorm", "rmsnorm_fwd", x.device, (x, scale, out),
               (rows, d, x.dtype == torch.bfloat16,
                scale.dtype == torch.bfloat16), (float(eps),))
    rmsnorm_cuda.launches += 1
    return out


rmsnorm_cuda.launches = 0
