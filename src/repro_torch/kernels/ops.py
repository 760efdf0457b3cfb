"""Public kernel entry points of the port, routed by tensor device.

Counterpart of ``repro/kernels/ops.py``.  There is no implementation
switch: a CPU tensor takes the plain version in ``ref.py``, a CUDA tensor
launches the hand-written kernel or raises.  No path gives way to the
plain version on the card.

Where a gradient is wanted (grad mode on and an input requires grad) the
call goes through the kernel's ``torch.autograd.Function``, whose forward
and backward route by device the same way; otherwise the launcher (or
plain version) is called directly, so serving pays nothing for autograd.

Under an active ``core.planner.plan_scope`` (the 2-D ``(nodes, model)``
engine), ``conv2d`` and ``dense`` take their layer's ``LayerPlan``, as the
reference's ``ops.conv2d`` / ``ops.dense`` do.  A ``channel`` fc runs the
column-parallel dataflow: K launches of K1 on K column shards of the
weight, each on its model device, gathered back into the full output
(K2 and K3 on the shards backward).  The plan's ``tile`` is recorded but
not passed on: the CUDA kernels choose their own tiles, and no kernel has
a tile knob.
"""
from __future__ import annotations

import torch

from repro_torch.core import planner

from . import conv2d as _conv
from . import dense as _dense
from . import flash_attention as _flash
from . import pool2d as _pool
from . import ref
from . import rmsnorm as _rmsnorm

__all__ = ["dense", "conv2d", "max_pool2d", "rmsnorm", "flash_attention"]


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _check_activation(activation):
    if activation not in _dense.ACTIVATIONS:
        raise ValueError(f"activation must be one of {_dense.ACTIVATIONS}")


def dense(x, w, b=None, activation: str = "none"):
    """Fused dense layer: x @ w (+ b) (+ activation).

    ``x`` may carry leading batch dims; they flatten into the kernel's row
    axis and reshape back.  ``w`` is cast to ``x.dtype`` as the reference
    does, and ``b`` enters the f32 epilogue.  Differentiable: K2 and K3
    are its backward on the card.  Under a ``channel`` LayerPlan the call
    runs column-parallel over the scope's model devices.
    """
    _check_activation(activation)
    lp = planner.take("fc")
    if lp is not None and lp.parallel_dim == "channel":
        return _column_parallel_dense(x, w, b, activation, lp)
    return _dense_call(x, w, b, activation)


def _column_parallel_dense(x, w, b, activation, lp):
    devices = planner.current_devices()
    if len(devices) != lp.shards:
        raise ValueError(f"{lp.name}: a {lp.shards}-way channel plan on "
                         f"{len(devices)} model devices")
    xs = planner.rep_in(x, devices)
    ws = planner.shard_dim(w, devices)
    bs = planner.shard_dim(b, devices) if b is not None else \
        (None,) * len(devices)
    outs = [_dense_call(xk, wk, bk, activation)
            for xk, wk, bk in zip(xs, ws, bs, strict=True)]
    return planner.gather_cols(outs, x.device)


def _dense_call(x, w, b, activation):
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    w = w.to(x.dtype).contiguous()
    cpu = x.device.type == "cpu"
    if b is not None and not cpu:
        b = b.to(torch.float32).contiguous()
    if _wants_grad(x2, w, b):
        out = _dense.DenseFunction.apply(x2, w, b, activation)
    elif cpu:
        out = ref.dense_ref(x2, w, b, activation=activation)
    else:
        out = _dense.dense_cuda(x2, w, b, activation=activation)
    return out.reshape(*lead, w.shape[-1])


def conv2d(x, w, b=None, padding: str = "SAME", stride: int = 1,
           activation: str = "none"):
    """Convolution + optional fused bias/activation (paper Eq. 1+2), NHWC
    x HWIO -> NHWC.  Differentiable: K4 forward, K5/K6 backward on the
    card.  The kernels are stride-1 (the paper's CNNs pool instead of
    striding); a strided call on a CUDA tensor raises
    ``NotImplementedError``, on a CPU tensor it takes the plain version."""
    _check_activation(activation)
    planner.take("conv")        # recorded; the conv kernels tile themselves
    if padding not in ("SAME", "VALID"):
        raise ValueError(padding)
    w = w.to(x.dtype)
    cpu = x.device.type == "cpu"
    if stride != 1:
        if not cpu:
            raise NotImplementedError(
                f"conv2d: stride={stride} has no kernel on the card (the "
                "conv kernels are stride-1)")
        return ref.conv2d_fused_ref(x, w, b, padding=padding, stride=stride,
                                    activation=activation)
    x = x.contiguous()
    w = w.contiguous()
    if _wants_grad(x, w, b):
        return _conv.Conv2dFunction.apply(x, w, b, padding, activation)
    if cpu:
        return ref.conv2d_fused_ref(x, w, b, padding=padding,
                                    activation=activation)
    return _conv.conv2d_cuda(x, w, b, padding=padding, activation=activation)


def max_pool2d(x, window: int = 2, stride: int = 2):
    """Non-overlapping max pooling (paper Eq. 15; backward Eq. 18, ties
    split evenly), NHWC; ``window`` must equal ``stride``."""
    if window != stride:
        raise ValueError(f"max_pool2d is non-overlapping only (stride == "
                         f"window), got window={window} stride={stride}")
    x = x.contiguous()
    if _wants_grad(x):
        return _pool.MaxPool2dFunction.apply(x, window)
    if x.device.type == "cpu":
        return ref.max_pool2d_ref(x, window, stride)
    return _pool.max_pool2d_cuda(x, window)


def _forward_only(name: str, *tensors):
    if _wants_grad(*tensors):
        raise NotImplementedError(
            f"{name} on the card is forward only: its backward kernel is not "
            "written (the reference has none either); call it without "
            "gradients, or on CPU tensors")


def rmsnorm(x, scale, eps: float = 1e-6):
    """RMSNorm over the last axis: x * rsqrt(mean(x^2) + eps) * scale in
    f32, cast to x's dtype.  ``x`` may carry leading dims.  K9 on the
    card, the plain version on the CPU.  Differentiable: K9's backward on
    the card (``rmsnorm.RmsNormFunction``)."""
    d = x.shape[-1]
    if _wants_grad(x, scale):
        out = _rmsnorm.RmsNormFunction.apply(x.reshape(-1, d).contiguous(),
                                             scale.contiguous(), eps)
        return out.reshape(x.shape)
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps=eps)
    out = _rmsnorm.rmsnorm_cuda(x.reshape(-1, d).contiguous(),
                                scale.contiguous(), eps=eps)
    return out.reshape(x.shape)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q (B, Sq, H, D), k and v (B, Sk, KH, D), BSHD like the models ->
    (B, Sq, H, D).  K10 on the card (forward only), transposed to its BHSD
    layout and back as the reference's ``ops.flash_attention`` does; on
    the CPU the plain version of what K10 computes."""
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if q.device.type == "cpu":
        out = ref.flash_attention_ref(qt, kt, vt, causal=causal,
                                      window=window, softcap=softcap)
    else:
        _forward_only("flash_attention", q, k, v)
        out = _flash.flash_attention_cuda(qt, kt, vt, causal=causal,
                                          window=window, softcap=softcap)
    return out.transpose(1, 2)
