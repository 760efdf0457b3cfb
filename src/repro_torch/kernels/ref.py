"""Plain PyTorch versions of the port's kernels.

Each is the CPU path of its kernel's wrapper and the yardstick the card's
kernel is held against.  Counterpart of ``repro/kernels/ref.py``; the
backward versions compute exactly what the backward kernels compute
(``repro/kernels/{dense,conv2d,pool2d}.py``'s ``_*_bwd`` wiring): the relu
mask taken from the saved output, the padded cotangent and flipped filter
of the conv input gradient, the even split of tied pool maxima.

Layouts are the reference's: NHWC activations, HWIO filters, dense
weights (Din, Dout).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["dense_ref", "dense_dx_ref", "dense_dwdb_ref", "conv_pads",
           "conv2d_ref", "conv2d_fused_ref", "conv2d_dx_ref", "conv2d_dw_ref",
           "max_pool2d_ref", "max_pool2d_bwd_ref"]


def _masked(g, out):
    """The cotangent through a relu whose output was ``out``: ``g`` where
    ``out > 0``, else 0.  ``out=None`` means no activation."""
    return g if out is None else g * (out > 0).to(g.dtype)


# ----------------------------------------------------------------- dense
def dense_ref(x, w, b=None, activation: str = "none"):
    """Fused dense: x @ w (+ b) (+ activation); x may carry leading dims."""
    out = x @ w.to(x.dtype)
    if b is not None:
        out = out + b.to(out.dtype)
    if activation == "relu":
        out = torch.relu(out)
    elif activation != "none":
        raise ValueError(activation)
    return out


def dense_dx_ref(g, w, out=None):
    """K2: dx = (g masked by ``out > 0``) @ w^T; g (M, Dout), w (Din, Dout)."""
    return _masked(g, out) @ w.t()


def dense_dwdb_ref(x, g, out=None):
    """K3: dw = x^T g and db = sum over rows of g (g masked by ``out > 0``),
    in f32; x (M, Din), g (M, Dout)."""
    g = _masked(g, out).float()
    return x.float().t() @ g, g.sum(0)


# ------------------------------------------------------------------ conv
def conv_pads(kh: int, kw: int, padding: str) -> tuple[int, int, int, int]:
    """(top, bottom, left, right) input padding: SAME pads (k-1)//2 before
    and the rest after (even k too), VALID none."""
    if padding == "SAME":
        ph, pw = (kh - 1) // 2, (kw - 1) // 2
        return ph, kh - 1 - ph, pw, kw - 1 - pw
    if padding == "VALID":
        return 0, 0, 0, 0
    raise ValueError(padding)


def conv2d_ref(x, w, padding: str = "SAME", stride: int = 1):
    """Convolution NHWC x HWIO -> NHWC (no bias, no activation)."""
    kh, kw = w.shape[0], w.shape[1]
    top, bottom, left, right = conv_pads(kh, kw, padding)
    xp = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    out = F.conv2d(xp, w.to(x.dtype).permute(3, 2, 0, 1), stride=stride)
    return out.permute(0, 2, 3, 1).contiguous()


def conv2d_fused_ref(x, w, b=None, padding: str = "SAME", stride: int = 1,
                     activation: str = "none"):
    """K4: act(conv(x, w) + b), the reference's ``ops.conv2d`` epilogue."""
    out = conv2d_ref(x, w, padding=padding, stride=stride)
    if b is not None:
        out = out + b.to(out.dtype)
    if activation == "relu":
        out = torch.relu(out)
    elif activation != "none":
        raise ValueError(activation)
    return out


def conv2d_dx_ref(g, w, x_shape, padding: str = "SAME", out=None):
    """K5: dL/dx of a stride-1 conv, as the VALID correlation of the
    cotangent (masked by ``out > 0``), padded by (k-1-pad_before,
    pad_before) per axis, with the filter flipped in space and its
    channels swapped."""
    kh, kw = w.shape[0], w.shape[1]
    top, bottom, left, right = conv_pads(kh, kw, padding)
    g = _masked(g, out)
    gp = F.pad(g.permute(0, 3, 1, 2),
               (kw - 1 - left, kw - 1 - right, kh - 1 - top, kh - 1 - bottom))
    wf = w.flip(0, 1).permute(2, 3, 0, 1)          # (Cin, Cout, kh, kw)
    dx = F.conv2d(gp, wf.to(g.dtype)).permute(0, 2, 3, 1)
    if tuple(dx.shape) != tuple(x_shape):
        raise ValueError(f"cotangent {tuple(g.shape)} does not come from "
                         f"an input of shape {tuple(x_shape)}")
    return dx.contiguous()


def conv2d_dw_ref(x, g, w_shape, padding: str = "SAME", out=None):
    """K6: dw[i,j,ci,co] = sum_{b,h,w} xpad[b,h+i,w+j,ci] g[b,h,w,co] and
    db = sum_{b,h,w} g, both f32 (g masked by ``out > 0``)."""
    kh, kw, cin, cout = w_shape
    top, bottom, left, right = conv_pads(kh, kw, padding)
    g = _masked(g, out).float()
    xp = F.pad(x.float(), (0, 0, left, right, top, bottom))
    Ho, Wo = g.shape[1], g.shape[2]
    gm = g.reshape(-1, cout)
    dw = torch.stack([
        torch.stack([xp[:, i:i + Ho, j:j + Wo, :].reshape(-1, cin).t() @ gm
                     for j in range(kw)]) for i in range(kh)])
    return dw, gm.sum(0)


# ------------------------------------------------------------------ pool
def _windows(x, window: int):
    """(B, Ho, k, Wo, k, C) view of the full windows; the remainder rows
    and columns are dropped."""
    B, H, W, C = x.shape
    Ho, Wo = H // window, W // window
    return x[:, :Ho * window, :Wo * window, :].reshape(
        B, Ho, window, Wo, window, C)


def max_pool2d_ref(x, window: int = 2, stride: int = 2):
    """K7: non-overlapping window max (window == stride), NHWC.  A reshape
    and an explicit window max; the remainder is dropped."""
    if window != stride:
        raise ValueError(f"max_pool2d is non-overlapping only (stride == "
                         f"window), got window={window} stride={stride}")
    return _windows(x, window).amax(dim=(2, 4))


def max_pool2d_bwd_ref(x, out, g, window: int = 2):
    """K8: the cotangent of each window goes to every position equal to
    its max, split by the number of ties; the remainder gets 0."""
    B, H, W, C = x.shape
    Ho, Wo = out.shape[1], out.shape[2]
    mask = (_windows(x, window) == out[:, :, None, :, None, :]).to(g.dtype)
    counts = mask.sum(dim=(2, 4), keepdim=True)
    routed = g[:, :, None, :, None, :] * mask / counts
    dx = torch.zeros((B, H, W, C), dtype=g.dtype, device=g.device)
    dx[:, :Ho * window, :Wo * window, :] = routed.reshape(
        B, Ho * window, Wo * window, C)
    return dx
