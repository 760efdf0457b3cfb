"""Flash attention: the wrapper around ``csrc/flash_attention.cu`` (K10).

Counterpart of ``repro/kernels/flash_attention.py``.  Forward only, as in
the reference: ``ops.flash_attention`` calls ``flash_attention_cuda`` on
CUDA tensors and ``ref.flash_attention_ref`` on CPU tensors, and raises
where a gradient is wanted on the card.  Layouts are the kernel's: q
(B, H, Sq, D), k and v (B, KH, Sk, D).
"""
from __future__ import annotations

import torch

from . import launch
from .ref import flash_pad_len

__all__ = ["flash_attention_cuda", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256
_DTYPES = (torch.bfloat16, torch.float32)


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0):
    """K10 on the card: online-softmax GQA attention with the reference's
    causal (ends aligned), sliding-window and soft-cap semantics.  q, k, v
    contiguous, one dtype (bfloat16 or float32), one CUDA device, outside
    autograd; head_dim at most 256.  A row with no live key returns what
    the TPU kernel at its default key tile (128) gives it.
    ``flash_attention_cuda.launches`` counts the launches."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda takes bfloat16 or float32 q, "
                        f"k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_cuda takes q (B, H, Sq, D) and "
                         f"k, v (B, KH, Sk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KH < 1 or H % KH:
        raise ValueError(f"flash_attention_cuda: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)} (H a multiple of KH)")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_cuda takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {D}")
    if min(B, H, Sq, Sk, D) < 1 or max(B, H) > 65535 or \
            max(Sq, Sk) >= 2**31 // 2:
        raise ValueError(f"flash_attention_cuda: unsupported shape q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if window < 0 or softcap < 0:
        raise ValueError(f"window {window} and softcap {softcap} must be "
                         ">= 0")
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError("flash_attention_cuda takes tensors on one CUDA "
                             f"device, got {q.device}, {k.device}, "
                             f"{v.device}")
        if not t.is_contiguous():
            raise ValueError("flash_attention_cuda takes contiguous tensors")
        if t.requires_grad:
            raise RuntimeError(
                "flash_attention_cuda is forward only (the reference has no "
                "backward either): call it outside autograd")
    out = torch.empty_like(q)
    launch.run("flash_attention", "flash_attention_fwd", q.device,
               (q, k, v, out),
               (B, H, KH, Sq, Sk, D, bool(causal), min(int(window), 2**31 - 1),
                flash_pad_len(Sk), q.dtype == torch.bfloat16),
               (1.0 / float(D) ** 0.5, float(softcap)))
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
