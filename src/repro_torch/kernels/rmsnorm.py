"""RMSNorm: the wrappers around ``csrc/rmsnorm.cu`` (K9, forward and
backward), and its ``torch.autograd.Function``.

Counterpart of ``repro/kernels/rmsnorm.py``, whose kernel is forward
only; the reference's models differentiate their jnp norm with
``jax.grad``, and ``rmsnorm_bwd_cuda`` computes that gradient.
``ops.rmsnorm`` calls ``rmsnorm_cuda`` on a CUDA tensor (``ref.rmsnorm_ref``
on a CPU one) where no gradient is wanted, and ``RmsNormFunction``
otherwise, whose forward and backward route by device the same way.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from torch.autograd.function import once_differentiable

from . import launch, ref

__all__ = ["RmsPlan", "rms_plan", "rmsnorm_cuda", "RmsBwdPlan", "bwd_plan",
           "rmsnorm_bwd_cuda", "RmsNormFunction"]

_DTYPES = (torch.bfloat16, torch.float32)
_THREADS = 256                 # the widest block
_PER_THREAD = (1, 2, 3, 4, 6, 8, 9)   # rmsnorm.cu's NV instances
_MAX_D = 12288                 # the staged scale: at most 48 KB
_ROW_BLOCKS = 132              # up to one row an SM: a block a row
_BWD_MAX_D = (48 * 1024 - 1024) // 4   # the backward's staged scale
_BWD_PER_THREAD = (1, 2, 3, 4, 6, 8, 12)   # rmsnorm.cu's backward NVs


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
                "rmsnorm_cuda launches outside autograd: differentiate "
                "through kernels.ops.rmsnorm")
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


class RmsBwdPlan(NamedTuple):
    """One launch of K9's backward: ``grid`` blocks of ``block`` threads,
    ``rows_per_block`` consecutive rows each; ``per_thread`` vectors (16
    bytes of columns) of a row's x and g in each thread's registers."""
    per_thread: int
    block: int
    rows_per_block: int
    grid: int


@functools.lru_cache(maxsize=256)   # every norm of a training step asks
def bwd_plan(rows: int, d: int, itemsize: int) -> RmsBwdPlan:
    """The geometry of K9's backward for x and g (rows, d) of
    ``itemsize`` bytes, d at most 12032: a block of the narrowest group of
    64, 128 or 256 threads that holds the row's vectors (the last one
    ragged where d is not a whole number of them) at up to 4 a thread, or
    256 threads with up to 12, at most 264 blocks (two an SM), none empty.
    Each block writes one dscale partial of d floats.  The kernel itself
    moves whole 16-byte vectors where the pointers and d allow, else
    single elements.  Depends on the shapes only, so every run adds the
    same partials in the same order."""
    nv = math.ceil(d * itemsize / 16)
    group = next((g for g in (64, 128, 256) if g * 4 >= nv), _THREADS)
    per = next(p for p in _BWD_PER_THREAD if p * group >= nv)
    rpb = math.ceil(rows / (2 * _ROW_BLOCKS))
    return RmsBwdPlan(per, group, rpb, math.ceil(rows / rpb))


def rmsnorm_bwd_cuda(x, scale, g, eps: float = 1e-6):
    """K9's backward on the card: x and g (rows, d) of one dtype,
    bfloat16 or float32, scale (d,) float32 or bfloat16, all contiguous on
    one CUDA device, outside autograd; d at most 12032.  Returns (dx in
    x's dtype, dscale f32 summed over the rows), ``ref.rmsnorm_bwd_ref``'s
    function, with the geometry ``bwd_plan`` gives.  Where it takes more
    than one block, their partial dscale sums go to the stream's
    workspace and a second pass adds them in block order;
    ``rmsnorm_bwd_cuda.launches`` counts the call as one."""
    dev, dt = launch.check_cuda("rmsnorm_bwd_cuda", _DTYPES, x=x, g=g)
    if launch.check_cuda("rmsnorm_bwd_cuda", _DTYPES, scale=scale)[0] \
            != dev:
        raise ValueError(f"rmsnorm_bwd_cuda takes tensors on one CUDA "
                         f"device, got {dev} and {scale.device}")
    if x.ndim != 2 or g.shape != x.shape or scale.shape != (x.shape[1],) \
            or x.numel() == 0 or x.shape[1] > _BWD_MAX_D \
            or x.shape[0] >= 2**31:
        raise ValueError(f"rmsnorm_bwd_cuda takes x and g (rows, d) and "
                         f"scale (d,), d <= {_BWD_MAX_D}, got "
                         f"{tuple(x.shape)}, {tuple(g.shape)} and "
                         f"{tuple(scale.shape)}")
    rows, d = x.shape
    plan = bwd_plan(rows, d, x.element_size())
    dx = torch.empty_like(x)
    dscale = torch.empty((d,), dtype=torch.float32, device=dev)
    part = None if plan.grid == 1 else launch.workspace(plan.grid * d, dev)
    launch.run("rmsnorm", "rmsnorm_bwd", dev, (x, scale, g, dx, part, dscale),
               (rows, d, dt == torch.bfloat16, scale.dtype == torch.bfloat16,
                *plan), (float(eps),))
    rmsnorm_bwd_cuda.launches += 1
    return dx, dscale


rmsnorm_bwd_cuda.launches = 0


class RmsNormFunction(torch.autograd.Function):
    """RMSNorm of x (rows, d) by scale (d,) with K9 forward and K9's
    backward on the card (``ref.rmsnorm_ref`` and ``ref.rmsnorm_bwd_ref``
    on the CPU).  Saves x and scale only: the backward recomputes the
    rows' rsqrt.  dscale (f32) comes back cast to scale's dtype."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        if x.device.type == "cpu":
            out = ref.rmsnorm_ref(x, scale, eps=eps)
        else:
            out = rmsnorm_cuda(x.detach(), scale.detach(), eps=eps)
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, scale = (launch.detached(t) for t in ctx.saved_tensors)
        fn = ref.rmsnorm_bwd_ref if x.device.type == "cpu" \
            else rmsnorm_bwd_cuda
        dx, dscale = fn(x, scale, g.contiguous(), ctx.eps)
        need_x, need_scale = ctx.needs_input_grad[:2]
        return (dx if need_x else None,
                dscale.to(scale.dtype) if need_scale else None, None)
