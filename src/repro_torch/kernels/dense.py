"""Fused dense forward: the wrapper around ``csrc/dense_fwd.cu``.

Counterpart of ``repro/kernels/dense.py`` (forward kernel only; its
backward kernels come with training).  ``ops.dense`` calls ``dense_cuda``
for CUDA tensors; CPU tensors take ``ref.dense_ref`` there.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["dense_cuda", "ACTIVATIONS"]

ACTIVATIONS = ("none", "relu")

_ENTRY = {torch.bfloat16: "dense_fwd_bf16", torch.float32: "dense_fwd_f32"}
_FNS: dict = {}


def _entry(dtype):
    fn = _FNS.get(dtype)
    if fn is None:
        fn = getattr(build.load("dense_fwd"), _ENTRY[dtype])
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return fn


def dense_cuda(x, w, b=None, activation: str = "none"):
    """act(x @ w + b) on the card: x (M, K), w (K, N), b (N,) float32 or
    None; x and w bfloat16 or float32, the same dtype, contiguous.

    Allocates the output, launches on the current stream, raises if the
    launch was refused.  ``dense_cuda.launches`` counts the launches.
    """
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {ACTIVATIONS}")
    if x.dtype not in _ENTRY or w.dtype != x.dtype:
        raise TypeError(f"dense_cuda takes bfloat16 or float32 x and w of "
                        f"one dtype, got {x.dtype} and {w.dtype}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"dense_cuda takes x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    M, K = x.shape
    N = w.shape[1]
    if min(M, N, K) < 1:
        raise ValueError(f"dense_cuda needs M, N, K >= 1, got {M}, {N}, {K}")
    tensors = [x, w] if b is None else [x, w, b]
    if b is not None and (b.dtype != torch.float32 or b.shape != (N,)):
        raise ValueError(f"bias must be float32 of shape ({N},), got "
                         f"{b.dtype} {tuple(b.shape)}")
    if any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "dense_cuda is forward-only (its backward kernels are not "
            "ported yet); call it on tensors that do not require grad")
    for t in tensors:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError("dense_cuda takes tensors on one CUDA device, "
                             f"got {[str(u.device) for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError("dense_cuda takes contiguous tensors")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry(x.dtype)(x.data_ptr(), w.data_ptr(),
                          None if b is None else b.data_ptr(),
                          out.data_ptr(), M, N, K,
                          int(activation == "relu"), stream)
    if err != 0:
        raise RuntimeError(f"dense_fwd launch failed: cudaError {err}")
    dense_cuda.launches += 1
    return out


dense_cuda.launches = 0

