"""What the kernel wrappers share: binding a C entry point, checking the
tensors it is handed, launching it on the current stream.

A launcher takes contiguous tensors of one dtype (f32 for the CNN's
kernels; f32 or bf16 for K2 and K3) on one CUDA device that do not
require grad (the autograd ``Function``s call it on detached tensors),
launches on PyTorch's current stream and raises if the launch was
refused.  It never synchronises and never falls back.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from . import build

__all__ = ["check_cuda", "check_f32_cuda", "detached", "run", "workspace"]

_FNS: dict = {}
_WORKSPACE: dict = {}   # (device, stream) -> f32 scratch of the split kernels


def _bind(lib: str, symbol: str, n_ptrs: int, n_ints: int, n_floats: int):
    fn = getattr(build.load(lib), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _FNS[(lib, symbol)] = fn
    return fn


def detached(t):
    """``t`` outside autograd (None stays None), for handing a Function's
    inputs to a launcher."""
    return None if t is None else t.detach()


def check_cuda(name: str, dtypes, **tensors):
    """Raise unless every given tensor (None skipped) is a contiguous
    tensor on one CUDA device outside autograd, all of one dtype among
    ``dtypes``; returns (that device, that dtype)."""
    given = {k: t for k, t in tensors.items() if t is not None}
    devices = {t.device for t in given.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name} takes tensors on one CUDA device, got "
                         f"{ {k: str(t.device) for k, t in given.items()} }")
    kinds = {t.dtype for t in given.values()}
    if len(kinds) != 1 or not kinds <= set(dtypes):
        raise TypeError(f"{name} takes tensors of one dtype among "
                        f"{[str(d) for d in dtypes]}, got "
                        f"{ {k: str(t.dtype) for k, t in given.items()} }")
    for key, t in given.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.requires_grad:
            raise RuntimeError(
                f"{name} launches outside autograd: pass tensors that do "
                "not require grad, or differentiate through kernels.ops")
    return next(iter(devices)), next(iter(kinds))


def check_f32_cuda(name: str, **tensors) -> torch.device:
    """``check_cuda`` for the f32-only kernels (K4-K8); returns the
    device."""
    return check_cuda(name, (torch.float32,), **tensors)[0]


def workspace(numel: int, device) -> torch.Tensor:
    """An f32 scratch buffer of at least ``numel`` elements for the partial
    sums of a kernel that splits its reduction (K1, K2, K3, K6).  One buffer
    per (device, stream), grown as needed and reused: launches on one
    stream run in order, each adding up its partials before the next
    starts, so a decode step or a training step saves an allocation per
    launch."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _WORKSPACE.get(key)
    if buf is None or buf.numel() < numel:
        buf = torch.empty(numel, dtype=torch.float32, device=device)
        _WORKSPACE[key] = buf
    return buf


def run(lib: str, symbol: str, device, ptrs, ints, floats=()) -> None:
    """Launch ``symbol`` of kernel library ``lib`` with ``ptrs`` (tensors
    or None), ``ints`` and ``floats`` (C ``float``) on ``device``'s current
    stream.  The C entries act on the calling thread's current device
    (their launch and their per-device attributes), so a launch on
    another card than the current one makes that card current for the
    call, as PyTorch's own ops do."""
    fn = _FNS.get((lib, symbol)) or _bind(lib, symbol, len(ptrs), len(ints),
                                          len(floats))
    guard = contextlib.nullcontext() if \
        device.index == torch.cuda.current_device() else \
        torch.cuda.device(device)
    with guard:
        err = fn(*[None if t is None else t.data_ptr() for t in ptrs],
                 *ints, *floats,
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")
