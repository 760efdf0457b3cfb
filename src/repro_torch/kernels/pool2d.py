"""Non-overlapping max pooling: the wrappers around ``csrc/pool2d.cu`` (K7
forward, K8 backward) and its ``torch.autograd.Function``.

Counterpart of ``repro/kernels/pool2d.py``.  NHWC, f32, window == stride;
remainder rows and columns are dropped and get zero gradient; tied maxima
share the cotangent evenly.  ``ops.max_pool2d`` calls ``max_pool2d_cuda``
directly where no gradient is needed and ``MaxPool2dFunction`` otherwise.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from . import launch, ref

__all__ = ["FwdPlan", "fwd_plan", "BwdPlan", "bwd_plan", "max_pool2d_cuda",
           "max_pool2d_bwd_cuda", "MaxPool2dFunction"]

_SMS = 132                     # H100 SXM


def _threads(total: int) -> int:
    """Threads a block: 256, or 128 or 64 where that gives every SM a
    block."""
    return next((t for t in (256, 128) if math.ceil(total / t) >= _SMS), 64)


class FwdPlan(NamedTuple):
    """One K7 launch: ``lanes`` channels a thread (4: a 16-byte vector),
    ``windows`` threads of (image, output window, lane group), ``threads``
    a block, ``blocks`` blocks."""
    lanes: int
    windows: int
    threads: int
    blocks: int


@functools.lru_cache(maxsize=64)   # every training step asks per layer
def fwd_plan(B: int, H: int, W: int, C: int, window: int,
             aligned: bool = True) -> FwdPlan:
    """The geometry of K7 for x (B, H, W, C): 4 channels a thread where C
    is a multiple of 4 and x and out start on 16 bytes (``aligned``), else
    1; one thread per output window and lane group."""
    lanes = 4 if C % 4 == 0 and aligned else 1
    windows = B * (H // window) * (W // window) * (C // lanes)
    threads = _threads(windows)
    return FwdPlan(lanes, windows, threads, math.ceil(windows / threads))


class BwdPlan(NamedTuple):
    """One K8 launch: ``lanes`` channels a thread (4: a 16-byte vector),
    ``windows`` threads of (image, output window, lane group), then
    ``remainder`` threads of (image, dropped position, lane group) that
    write zeros; ``threads`` a block, ``blocks`` blocks."""
    lanes: int
    windows: int
    remainder: int
    threads: int
    blocks: int


@functools.lru_cache(maxsize=64)   # every training step asks per layer
def bwd_plan(B: int, H: int, W: int, C: int, window: int,
             aligned: bool = True) -> BwdPlan:
    """The geometry of K8 for x (B, H, W, C): 4 channels a thread where C
    is a multiple of 4 and every tensor starts on 16 bytes (``aligned``),
    else 1; one thread per output window and lane group, then one per
    dropped (remainder) position and lane group; blocks of 256 threads,
    or 128 or 64 where that gives every SM a block."""
    lanes = 4 if C % 4 == 0 and aligned else 1
    Ho, Wo = H // window, W // window
    dropped = (H - Ho * window) * W + Ho * window * (W - Wo * window)
    windows = B * Ho * Wo * (C // lanes)
    remainder = B * dropped * (C // lanes)
    total = windows + remainder
    threads = _threads(total)
    return BwdPlan(lanes, windows, remainder, threads,
                   math.ceil(total / threads))


def _check_window(name, x, window):
    if x.ndim != 4 or window < 1 or x.shape[1] // window < 1 \
            or x.shape[2] // window < 1:
        raise ValueError(f"{name}: input {tuple(x.shape)} (B, H, W, C) "
                         f"smaller than the {window}x{window} window")


def max_pool2d_cuda(x, window: int = 2):
    """K7 on the card: the max of each window x window tile of x (B, H, W,
    C).  ``max_pool2d_cuda.launches`` counts the launches."""
    dev = launch.check_f32_cuda("max_pool2d_cuda", x=x)
    _check_window("max_pool2d_cuda", x, window)
    B, H, W, C = x.shape
    out = torch.empty((B, H // window, W // window, C), dtype=torch.float32,
                      device=dev)
    plan = fwd_plan(B, H, W, C, window,
                    x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    launch.run("pool2d", "max_pool2d_fwd_f32", dev, (x, out),
               (B, H, W, C, window, plan.lanes, plan.threads, plan.blocks))
    max_pool2d_cuda.launches += 1
    return out


def max_pool2d_bwd_cuda(x, out, g, window: int = 2):
    """K8 on the card: dL/dx from the input x, the saved output and its
    cotangent g.  ``max_pool2d_bwd_cuda.launches`` counts the launches."""
    dev = launch.check_f32_cuda("max_pool2d_bwd_cuda", x=x, out=out, g=g)
    _check_window("max_pool2d_bwd_cuda", x, window)
    B, H, W, C = x.shape
    if tuple(out.shape) != (B, H // window, W // window, C) \
            or g.shape != out.shape:
        raise ValueError(f"max_pool2d_bwd_cuda: out {tuple(out.shape)} and "
                         f"g {tuple(g.shape)} do not pool x {tuple(x.shape)}")
    dx = torch.empty_like(x)
    plan = bwd_plan(B, H, W, C, window, all(
        t.data_ptr() % 16 == 0 for t in (x, out, g, dx)))
    launch.run("pool2d", "max_pool2d_bwd_f32", dev, (x, out, g, dx),
               (B, H, W, C, window, plan.lanes, plan.threads, plan.blocks))
    max_pool2d_bwd_cuda.launches += 1
    return dx


max_pool2d_cuda.launches = 0
max_pool2d_bwd_cuda.launches = 0


class MaxPool2dFunction(torch.autograd.Function):
    """Max pooling with K7 forward and K8 backward on the card (the plain
    versions on the CPU); the saved output is the argmax oracle."""

    @staticmethod
    def forward(ctx, x, window):
        if x.device.type == "cpu":
            out = ref.max_pool2d_ref(x, window, window)
        else:
            out = max_pool2d_cuda(x.detach(), window)
        ctx.save_for_backward(x, out)
        ctx.window = window
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, out = (t.detach() for t in ctx.saved_tensors)
        bwd = (ref.max_pool2d_bwd_ref if x.device.type == "cpu"
               else max_pool2d_bwd_cuda)
        return bwd(x, out, g.contiguous(), ctx.window), None
