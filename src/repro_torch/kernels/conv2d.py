"""Stride-1 convolution: the wrappers around ``csrc/conv2d.cu`` (K4 forward,
K5 input gradient, K6 weight/bias gradient) and its
``torch.autograd.Function``.

Counterpart of ``repro/kernels/conv2d.py``.  Layout NHWC x HWIO -> NHWC,
f32.  ``ops.conv2d`` calls ``conv2d_cuda`` directly where no gradient is
needed and ``Conv2dFunction`` otherwise; inside it a CUDA tensor launches
the kernels and a CPU tensor takes their plain versions in ``ref.py``.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.autograd.function import once_differentiable

from . import launch, ref

__all__ = ["conv2d_cuda", "conv2d_dx_cuda", "conv2d_dw_cuda",
           "Conv2dFunction", "conv_tile", "conv_tiles", "conv_smem",
           "dw_tile", "dw_splits", "dw_smem"]

_SMS = 132              # the H100's SMs
_DW_PIXELS = (256, 128, 64, 32, 16)   # pixels a K6 block owns, largest first
_CONV_PIXELS = (256, 128, 64, 32, 16, 8, 4)   # pixels a K4/K5 block owns
_SMEM = 227 * 1024      # the H100's opt-in shared memory a block
_THREADS = 256          # conv2d.cu's kThreads


def _out_hw(H, W, kh, kw, padding):
    if padding == "SAME":
        return H, W
    return H - kh + 1, W - kw + 1


def _check_shapes(name, x_shape, w, padding):
    if len(x_shape) != 4 or w.ndim != 4 or x_shape[3] != w.shape[2]:
        raise ValueError(f"{name} takes x (B, H, W, Cin) and w (kh, kw, "
                         f"Cin, Cout), got {tuple(x_shape)} and "
                         f"{tuple(w.shape)}")
    Ho, Wo = _out_hw(x_shape[1], x_shape[2], w.shape[0], w.shape[1], padding)
    if Ho < 1 or Wo < 1:
        raise ValueError(f"{name}: a {w.shape[0]}x{w.shape[1]} VALID filter "
                         f"does not fit a {x_shape[1]}x{x_shape[2]} input")
    return Ho, Wo


def conv2d_cuda(x, w, b=None, padding: str = "SAME",
                activation: str = "none"):
    """K4 on the card: act(conv(x, w) + b), x (B, H, W, Cin), w (kh, kw,
    Cin, Cout), b (Cout,) or None, f32, stride 1; one block a
    ``conv_tile`` tile of output pixels.  ``conv2d_cuda.launches`` counts
    the launches."""
    dev = launch.check_f32_cuda("conv2d_cuda", x=x, w=w, b=b)
    B, H, W, Cin = x.shape
    Ho, Wo = _check_shapes("conv2d_cuda", x.shape, w, padding)
    kh, kw, _, Cout = w.shape
    if b is not None and tuple(b.shape) != (Cout,):
        raise ValueError(f"conv2d_cuda: bias must be ({Cout},), got "
                         f"{tuple(b.shape)}")
    top, _, left, _ = ref.conv_pads(kh, kw, padding)
    out = torch.empty((B, Ho, Wo, Cout), dtype=torch.float32, device=dev)
    launch.run("conv2d", "conv2d_tile_f32", dev, (x, w, b, None, out),
               (B, H, W, Cin, Ho, Wo, Cout, kh, kw, top, left, 0,
                activation == "relu",
                *conv_tile(B, Ho, Wo, Cin, Cout, kh, kw, False)))
    conv2d_cuda.launches += 1
    return out


def conv2d_dx_cuda(g, w, x_shape, padding: str = "SAME", out=None):
    """K5 on the card: dL/dx (``x_shape``) of a stride-1 conv from its
    cotangent g (B, Ho, Wo, Cout), masked by ``out > 0``; K4's kernel on
    the cotangent with the mirrored padding and the flipped,
    channel-swapped filter.  ``conv2d_dx_cuda.launches`` counts the
    launches."""
    dev = launch.check_f32_cuda("conv2d_dx_cuda", g=g, w=w, out=out)
    Ho, Wo = _check_shapes("conv2d_dx_cuda", x_shape, w, padding)
    B, H, W, Cin = x_shape
    kh, kw, _, Cout = w.shape
    if tuple(g.shape) != (B, Ho, Wo, Cout) or (
            out is not None and out.shape != g.shape):
        raise ValueError(f"conv2d_dx_cuda: cotangent {tuple(g.shape)} does "
                         f"not match input {tuple(x_shape)} and filter "
                         f"{tuple(w.shape)}")
    top, _, left, _ = ref.conv_pads(kh, kw, padding)
    dx = torch.empty((B, H, W, Cin), dtype=torch.float32, device=dev)
    launch.run("conv2d", "conv2d_tile_f32", dev, (g, w, None, out, dx),
               (B, Ho, Wo, Cout, H, W, Cin, kh, kw, kh - 1 - top,
                kw - 1 - left, 1, 0,
                *conv_tile(B, H, W, Cout, Cin, kh, kw, True)))
    conv2d_dx_cuda.launches += 1
    return dx


def _tile_of(B, Ho, Wo, pixels):
    """(images, rows, columns) of a tile of at most ``pixels`` output
    pixels: whole images where one image has no more, else whole rows,
    else part of a row."""
    if Ho * Wo <= pixels:
        return min(B, pixels // (Ho * Wo)), Ho, Wo
    if Wo <= pixels:
        return 1, pixels // Wo, Wo
    return 1, 1, pixels


def conv_smem(tile, chunk, taps, Cin, Cout, kh, kw, flip) -> int:
    """Bytes of shared memory one K4 (``flip`` False) or K5 (True) block
    takes for output-pixel ``tile`` = (images, rows, columns), staging
    ``chunk`` input channels of ``taps`` taps at a time: the ring of x
    patch (K5 also its mask) and filter panel, one stage or two where the
    reduction takes several chunks, or the reduction slices' partials
    where those are larger; then the bias, the patch offset of every tap's
    channel quads and two tables of the tile's pixels.  conv2d.cu's
    ``ConvPlan::smem`` is the kernel's own count (its
    ``conv2d_tile_smem``); a test on the card holds the two equal."""
    tb, th, tw = tile
    cn = min(16, math.ceil(Cout / 4) * 4)
    cq = math.ceil(chunk / 4)
    cs = 4 * cq if cq % 2 else 4 * cq + 4
    stages = 2 if chunk < Cin or taps < kh * kw else 1
    pixels = tb * th * tw
    jobs = math.ceil(pixels / 4) * (cn // 4)
    slices = max(1, min(_THREADS // jobs, taps * cq))
    xs = tb * (th + kh - 1) * (tw + kw - 1) * cs
    stage = xs * (2 if flip else 1) + taps * 4 * cq * cn
    region = max(stages * stage, slices * jobs * 16)
    return 4 * (region + cn + kh * kw * cq + 2 * pixels)


def _largest(fits, top):
    """The largest n in 1 .. top with fits(n), fits being monotone (true
    up to some n), or None."""
    if not fits(1):
        return None
    lo, hi = 1, top
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo


@functools.lru_cache(maxsize=256)   # every training step asks per layer
def conv_tile(B, Ho, Wo, Cin, Cout, kh, kw, flip) -> tuple[int, ...]:
    """(images, rows, columns, chunk, taps) of one K4 (``flip`` False) or
    K5 (True) block.  The output pixels it owns: the most of 256, 128,
    ..., 4 that still gives one tile an SM (4 where B.Ho.Wo is too small
    for that).  What it stages at a time: all of Cin and every tap where
    that fits the 227 KB of shared memory a block may opt in to; else the
    most channels (a multiple of 4, or 1-3) of every tap that fit a
    two-stage ring; else one channel of the most taps that fit, the pixels
    halving first.  Depends on the shapes only, so every run sums in the
    same order.  Raises where one pixel's single-channel patch does not
    fit."""
    total = B * Ho * Wo
    taps = kh * kw
    pixels = next((p for p in _CONV_PIXELS if math.ceil(total / p) >= _SMS),
                  _CONV_PIXELS[-1])
    while True:
        tile = _tile_of(B, Ho, Wo, pixels)

        def fits(chunk, t=taps, tile=tile):
            return conv_smem(tile, chunk, t, Cin, Cout, kh, kw,
                             flip) <= _SMEM
        if fits(Cin):
            return (*tile, Cin, taps)
        quads = _largest(lambda n: fits(4 * n), Cin // 4) if Cin > 4 else None
        chunk = 4 * quads if quads else next(
            (c for c in (3, 2, 1) if c < Cin and fits(c)), None)
        if chunk:
            return (*tile, chunk, taps)
        if pixels == 1:
            break
        pixels //= 2
    t = _largest(lambda n: fits(1, n), taps)
    if t is None:
        raise ValueError(f"conv2d_cuda: one pixel's {kh}x{kw} "
                         "single-channel patch does not fit a block's 227 "
                         "KB of shared memory")
    return (*tile, 1, t)


def conv_tiles(B, Ho, Wo, Cin, Cout, kh, kw, flip) -> int:
    """How many tiles of output pixels (blocks along grid.x) a K4 or K5
    launch has (``conv_tile``)."""
    tb, th, tw = conv_tile(B, Ho, Wo, Cin, Cout, kh, kw, flip)[:3]
    return math.ceil(B / tb) * math.ceil(Ho / th) * math.ceil(Wo / tw)


def dw_smem(tile, Cin, Cout, kh, kw) -> int:
    """Bytes of shared memory one K6 pass-1 block takes for output-pixel
    ``tile`` = (images, rows, columns): the x patch with its halo (rounded
    to 16 bytes), the g tile of its channel chunk and its mask, and the
    pixels' patch offsets, or the pixel groups' sums where those are
    larger.  conv2d.cu's ``DwPlan::smem`` is the kernel's own count (its
    ``conv2d_dw_smem``); a test on the card holds the two equal."""
    tb, th, tw = tile
    ct = min(16, math.ceil(Cout / 4) * 4)
    jobs = min(math.ceil((kh * kw * Cin + 1) / 4), _THREADS // (ct // 4)) \
        * (ct // 4)
    pixels = tb * th * tw
    xs = math.ceil(tb * (th + kh - 1) * (tw + kw - 1) * Cin / 4) * 4
    return 4 * max(xs + 2 * pixels * ct + pixels,
                   (_THREADS // jobs) * jobs * 16)


@functools.lru_cache(maxsize=256)   # every training step asks per layer
def dw_tile(B, Ho, Wo, Cin, Cout, kh, kw) -> tuple[int, int, int]:
    """(images, rows, columns) of the output pixels one K6 pass-1 block
    owns: the most pixels of 256, 128, 64, 32 and 16 that still gives one
    tile an SM (16 where B.Ho.Wo is too small for that), whole images where one
    image has no more pixels, else whole rows; halved until the block's
    shared memory fits the 227 KB a block may opt in to.  Depends on the
    shapes only, so every run adds the same partials in the same order.
    Raises where even one pixel's x patch does not fit (kh.kw.Cin above
    about 58 000 floats)."""
    total = B * Ho * Wo
    pixels = next((p for p in _DW_PIXELS if math.ceil(total / p) >= _SMS),
                  _DW_PIXELS[-1])
    while True:
        tile = _tile_of(B, Ho, Wo, pixels)
        if dw_smem(tile, Cin, Cout, kh, kw) <= _SMEM:
            return tile
        if pixels == 1:
            raise ValueError(f"conv2d_dw_cuda: one pixel's {kh}x{kw}x{Cin} "
                             "x patch does not fit a block's 227 KB of "
                             "shared memory")
        pixels //= 2


def dw_splits(B, Ho, Wo, Cin, Cout, kh, kw) -> int:
    """How many tiles K6 splits its B.Ho.Wo reduction into (``dw_tile``):
    pass 2 adds that many partials per output."""
    tb, th, tw = dw_tile(B, Ho, Wo, Cin, Cout, kh, kw)
    return math.ceil(B / tb) * math.ceil(Ho / th) * math.ceil(Wo / tw)


def conv2d_dw_cuda(x, g, w_shape, padding: str = "SAME", out=None):
    """K6 on the card: (dw, db) of a stride-1 conv, f32, from its input x
    and cotangent g masked by ``out > 0``.  Two passes (one partial sum per
    ``dw_tile`` tile of output pixels, into the stream's workspace, then
    their fixed-order total) make one launch of the kernel:
    ``conv2d_dw_cuda.launches`` counts them."""
    dev = launch.check_f32_cuda("conv2d_dw_cuda", x=x, g=g, out=out)
    kh, kw, Cin, Cout = w_shape
    B, H, W, _ = x.shape
    Ho, Wo = _out_hw(H, W, kh, kw, padding)
    if x.ndim != 4 or x.shape[3] != Cin or tuple(g.shape) != (
            B, Ho, Wo, Cout) or (out is not None and out.shape != g.shape):
        raise ValueError(f"conv2d_dw_cuda: x {tuple(x.shape)} and cotangent "
                         f"{tuple(g.shape)} do not match filter "
                         f"{tuple(w_shape)}")
    top, _, left, _ = ref.conv_pads(kh, kw, padding)
    tile = dw_tile(B, Ho, Wo, Cin, Cout, kh, kw)
    splits = dw_splits(B, Ho, Wo, Cin, Cout, kh, kw)
    part = launch.workspace(splits * (kh * kw * Cin + 1) * Cout, dev)
    dw = torch.empty(tuple(w_shape), dtype=torch.float32, device=dev)
    db = torch.empty((Cout,), dtype=torch.float32, device=dev)
    launch.run("conv2d", "conv2d_dw_f32", dev, (x, g, out, part, dw, db),
               (B, H, W, Cin, Ho, Wo, Cout, kh, kw, top, left, *tile))
    conv2d_dw_cuda.launches += 1
    return dw, db


conv2d_cuda.launches = 0
conv2d_dx_cuda.launches = 0
conv2d_dw_cuda.launches = 0


class Conv2dFunction(torch.autograd.Function):
    """act(conv(x, w) + b), stride 1, with K4 forward and K5/K6 backward on
    the card (the plain versions on the CPU).  The relu mask comes from the
    saved output, as in the reference's ``_conv2d_bwd``."""

    @staticmethod
    def forward(ctx, x, w, b, padding, activation):
        if x.device.type == "cpu":
            out = ref.conv2d_fused_ref(x, w, b, padding=padding,
                                       activation=activation)
        else:
            out = conv2d_cuda(x.detach(), w.detach(), launch.detached(b),
                              padding=padding, activation=activation)
        ctx.save_for_backward(x, w, out if activation == "relu" else None)
        ctx.padding = padding
        ctx.b_dtype = None if b is None else b.dtype
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w, out = (launch.detached(t) for t in ctx.saved_tensors)
        g = g.contiguous()
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = dw = db = None
        cpu = x.device.type == "cpu"
        if need_x:
            dx = (ref.conv2d_dx_ref if cpu else conv2d_dx_cuda)(
                g, w, x.shape, ctx.padding, out).to(x.dtype)
        if need_w or need_b:
            dw, db = (ref.conv2d_dw_ref if cpu else conv2d_dw_cuda)(
                x, g, w.shape, ctx.padding, out)
            dw = dw.to(w.dtype) if need_w else None
            db = db.to(ctx.b_dtype) if need_b else None
        return dx, dw, db, None, None
