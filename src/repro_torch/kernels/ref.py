"""Plain PyTorch versions of the port's kernels.

Each is the CPU path of its kernel's wrapper and the yardstick the card's
kernel is held against.  Counterpart of ``repro/kernels/ref.py``; the
backward versions compute exactly what the backward kernels compute
(``repro/kernels/{dense,conv2d,pool2d}.py``'s ``_*_bwd`` wiring): the relu
mask taken from the saved output, the padded cotangent and flipped filter
of the conv input gradient, the even split of tied pool maxima.

Layouts are the reference's: NHWC activations, HWIO filters, dense
weights (Din, Dout); ``attention_ref`` takes BSHD like the models,
``flash_attention_ref`` BHSD like K10.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["dense_ref", "dense_dx_ref", "dense_dwdb_ref", "conv_pads",
           "conv2d_ref", "conv2d_fused_ref", "conv2d_dx_ref", "conv2d_dw_ref",
           "max_pool2d_ref", "max_pool2d_bwd_ref", "rmsnorm_ref",
           "rmsnorm_bwd_ref",
           "attention_ref", "flash_attention_ref", "flash_pad_len",
           "NEG_INF"]

NEG_INF = -1e30            # the finite "masked" score of the reference


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
    """K2: dx = (g masked by ``out > 0``) @ w^T; g (M, Dout), w (Din,
    Dout).  Computed in f32 and rounded once to g's dtype, as the
    reference's ``preferred_element_type=f32`` product and cast."""
    return (_masked(g, out).float() @ w.float().t()).to(g.dtype)


def dense_dwdb_ref(x, g, out=None, dw_dtype=torch.float32,
                   want_db: bool = True):
    """K3: dw = x^T g, computed in f32 and returned in ``dw_dtype``, and
    db = sum over rows of g in f32 where ``want_db`` (else None); g masked
    by ``out > 0``; x (M, Din), g (M, Dout)."""
    g = _masked(g, out).float()
    return (x.float().t() @ g).to(dw_dtype), g.sum(0) if want_db else None


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


# --------------------------------------------------------------- rmsnorm
def rmsnorm_ref(x, scale, eps: float = 1e-6):
    """K9: per row of x (..., d), x * rsqrt(mean(x^2) + eps) * scale in
    f32, cast to x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd_ref(x, scale, g, eps: float = 1e-6):
    """K9's backward: the gradient of ``rmsnorm_ref`` for the cotangent g
    of its output, all in f32 as ``jax.grad`` of the reference's jnp norm
    computes it.  Per row, r = rsqrt(mean(x^2) + eps), x^ = x r and dy =
    g scale: dx = r (dy - x^ mean(dy x^)) in x's dtype, and dscale = the
    sum of g x^ over every row, f32."""
    xf, gf = x.float(), g.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xhat = xf * r
    dy = gf * scale.float()
    dx = r * (dy - xhat * (dy * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype), (gf * xhat).reshape(-1, x.shape[-1]).sum(0)


# ------------------------------------------------------------- attention
def attention_ref(q, k, v, *, causal=True, window=None, softcap=0.0,
                  scale=None):
    """The naive O(S^2) GQA attention oracle of the reference (``ref.py``'s
    ``attention_ref``): q (B, Sq, H, D), k and v (B, Sk, KH, D).  A row
    with no live key averages v over the Sk keys."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    if not scale:
        scale = float(np.float32(1.0) / np.sqrt(np.float32(D)))
    qg = q.reshape(B, Sq, KH, G, D)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg.float(), k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qi = torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kj <= qi + (Sk - Sq))      # ends aligned
    if window:
        mask = mask & ((qi + (Sk - Sq)) - kj < window)
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def flash_pad_len(sk: int, k_tile: int = 128) -> int:
    """nk * tk: the key length K10 pads k and v to, tk = min(k_tile, Sk)."""
    tk = min(k_tile, sk)
    return -(-sk // tk) * tk


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, k_tile: int = 128):
    """Exactly what K10 computes (``flash_attention.py``'s
    ``_flash_kernel``): q (B, H, Sq, D), k and v (B, KH, Sk, D) -> (B, H,
    Sq, D) in q's dtype.

    k and v are padded with zeros to ``flash_pad_len(Sk, k_tile)`` keys
    and every score outside the kv-padding, causal (ends aligned) and
    window masks is -1e30 after the soft-cap.  One softmax over the padded
    keys, normalised at the end as K10 does (acc / max(l, 1e-20)), equals
    K10's online one up to rounding; a row with no live key (causal,
    Sq > Sk) puts p = 1 on every padded key and returns sum(v) / (nk*tk),
    where ``attention_ref`` returns sum(v) / Sk.  Updates its own score
    tensor in place, so an S = 8192 call holds one f32 score tensor.
    """
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    G = H // KH
    P = flash_pad_len(Sk, k_tile)
    kp = F.pad(k.float(), (0, 0, 0, P - Sk))
    vp = F.pad(v.float(), (0, 0, 0, P - Sk))
    s = torch.matmul(q.float().reshape(B, KH, G, Sq, D),
                     kp[:, :, None].transpose(-1, -2))   # (B, KH, G, Sq, P)
    s.mul_(1.0 / float(D) ** 0.5)
    if softcap:
        s.div_(softcap).tanh_().mul_(softcap)
    qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kj = torch.arange(P, device=q.device)[None, :]
    mask = kj < Sk
    if causal:
        mask = mask & (kj <= qi)
    if window:
        mask = mask & (qi - kj < window)
    s.masked_fill_(~mask, NEG_INF)
    s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    l = s.sum(dim=-1, keepdim=True).clamp_min_(1e-20)
    o = torch.matmul(s, vp[:, :, None]).div_(l)
    return o.reshape(B, H, Sq, D).to(q.dtype)
