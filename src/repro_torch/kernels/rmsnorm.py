"""RMSNorm: the wrapper around ``csrc/rmsnorm.cu`` (K9).

Counterpart of ``repro/kernels/rmsnorm.py``.  Forward only, as in the
reference: ``ops.rmsnorm`` calls ``rmsnorm_cuda`` on a CUDA tensor and
``ref.rmsnorm_ref`` on a CPU tensor, and raises where a gradient is
wanted on the card.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from . import launch

__all__ = ["RmsPlan", "rms_plan", "rmsnorm_cuda"]

_DTYPES = (torch.bfloat16, torch.float32)
_THREADS = 256                 # the widest block
_PER_THREAD = (1, 2, 3, 4, 6, 8, 9)   # rmsnorm.cu's NV instances
_MAX_D = 12288                 # the staged scale: at most 48 KB
_ROW_BLOCKS = 132              # up to one row an SM: a block a row


class RmsPlan(NamedTuple):
    """One K9 launch: ``per_thread`` 16-byte vectors of a row in each of
    ``group`` threads, blocks of ``block`` threads (``block // group``
    consecutive rows), ``grid`` blocks; ``per_thread`` 0 is the chunked
    two-pass kernel, a block of ``block`` threads a row."""
    group: int
    per_thread: int
    block: int
    grid: int


@functools.lru_cache(maxsize=256)   # every norm of a forward asks
def rms_plan(rows: int, d: int, itemsize: int, aligned: bool = True
             ) -> RmsPlan:
    """The geometry of K9 for x (rows, d) of ``itemsize`` bytes.

    Rows whose x and scale start on 16 bytes (``aligned``: the scale a
    whole number of 16-byte vectors too), with d a whole number of 16-byte
    vectors and at most 12288, stay in registers, at most 9 vectors a
    thread (NV, the smallest instance that covers the row).  Up to 132
    rows each gets a block of up to 256 threads (a round trip a row);
    beyond, a row gets the narrowest group of 32, 64, 128 or 256 threads
    that holds it, 256 / group consecutive rows a block.  Every other
    shape takes the chunked kernel, a block a row, as wide as the row's
    vectors need between 32 and 256 threads.  Depends on the shapes only,
    so every run sums in the same order."""
    V = 16 // itemsize
    nv = d // V
    if not aligned or d % V or d > _MAX_D \
            or nv > _THREADS * _PER_THREAD[-1]:
        threads = min(_THREADS, max(32, math.ceil(math.ceil(d / V) / 32)
                                    * 32))
        return RmsPlan(threads, 0, threads, rows)
    if rows <= _ROW_BLOCKS:
        group = min(_THREADS, math.ceil(nv / 32) * 32)
        block = group
    else:
        group = next(g for g in (32, 64, 128, 256)
                     if g * _PER_THREAD[-1] >= nv)
        block = _THREADS
    per = next(p for p in _PER_THREAD if p * group >= nv)
    return RmsPlan(group, per, block, math.ceil(rows / (block // group)))


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
    plan = rms_plan(rows, d, x.element_size(),
                    (x.data_ptr() | scale.data_ptr()) % 16 == 0
                    and d * scale.element_size() % 16 == 0)
    launch.run("rmsnorm", "rmsnorm_fwd", x.device, (x, scale, out),
               (rows, d, x.dtype == torch.bfloat16,
                scale.dtype == torch.bfloat16, *plan), (float(eps),))
    rmsnorm_cuda.launches += 1
    return out


rmsnorm_cuda.launches = 0
