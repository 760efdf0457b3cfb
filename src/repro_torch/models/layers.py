"""Common layers, from ``repro/models/layers.py`` (params as dicts).

Init functions take a ``torch.Generator``.  The LM ones also take a
``stack`` shape that is prepended to every leaf, so a layer stack is drawn
in place with its leading ``L`` axis (as the reference's ``vmap`` over
layer keys lays it out) instead of being stacked afterwards.  The CNN's
layers keep the reference's layouts: HWIO filters, (Din, Dout) weights.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.shardlib import constrain
from repro_torch.kernels import ops

__all__ = [
    "init_rms_norm", "rms_norm", "softcap", "init_dense", "dense",
    "init_mlp", "mlp", "rope_frequencies", "apply_rope", "init_embedding",
    "embed",
    "init_conv2d", "conv2d", "init_fc", "fc",
]


def _normal(gen, shape, scale, dtype, device):
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device) * scale


def init_rms_norm(d: int, *, stack=(), dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((*stack, d), dtype=dtype, device=device)}


def rms_norm(params, x, eps: float = 1e-6):
    """RMSNorm in f32, cast back to ``x.dtype``: the reference's layer,
    which computes K9's function, so it goes through ``ops.rmsnorm`` (K9 on
    the card, the plain version on the CPU)."""
    return ops.rmsnorm(x, params["scale"], eps)


def softcap(x, cap: float):
    """Gemma-2 logit soft-capping: cap * tanh(x / cap), in x's dtype."""
    return torch.tanh(x / cap) * cap


def init_dense(gen, d_in: int, d_out: int, *, stack=(), dtype=torch.float32,
               device="cpu"):
    return {"w": _normal(gen, (*stack, d_in, d_out), 1.0 / math.sqrt(d_in),
                         dtype, device)}


def dense(params, x):
    """Bias-free projection through the port's dense kernel."""
    return ops.dense(x, params["w"])


def init_conv2d(gen, kh: int, kw: int, c_in: int, c_out: int, *,
                dtype=torch.float32, device="cpu"):
    """He-initialised HWIO conv filter (std sqrt(2 / fan_in)) + zero bias."""
    return {"w": _normal(gen, (kh, kw, c_in, c_out),
                         math.sqrt(2.0 / (c_in * kh * kw)), dtype, device),
            "b": torch.zeros((c_out,), dtype=dtype, device=device)}


def conv2d(params, x, padding: str = "SAME", stride: int = 1,
           activation: str = "none"):
    """Conv + fused bias/activation through the port's conv kernels."""
    return ops.conv2d(x, params["w"], params["b"], padding=padding,
                      stride=stride, activation=activation)


def init_fc(gen, d_in: int, d_out: int, *, dtype=torch.float32,
            device="cpu"):
    """He-initialised full-connection layer (weight + zero bias, §4.1.2)."""
    return {"w": _normal(gen, (d_in, d_out), math.sqrt(2.0 / d_in), dtype,
                         device),
            "b": torch.zeros((d_out,), dtype=dtype, device=device)}


def fc(params, x, activation: str = "none"):
    """Full-connection layer + fused bias/activation through ``ops.dense``
    (K1 forward, K2/K3 backward on the card)."""
    return ops.dense(x, params["w"], params["b"], activation=activation)


def init_mlp(gen, d_model: int, d_ff: int, *, stack=(), dtype=torch.float32,
             device="cpu"):
    kw = dict(stack=stack, dtype=dtype, device=device)
    return {
        "wi": init_dense(gen, d_model, d_ff, **kw),
        "wg": init_dense(gen, d_model, d_ff, **kw),
        "wo": init_dense(gen, d_ff, d_model, **kw),
    }


def mlp(params, x, activation: str = "silu", megatron: bool = False):
    """Gated MLP (SwiGLU / GeGLU; ``jax.nn.gelu``'s tanh form).

    megatron=True keeps the reference's tensor-parallel dataflow under
    sharding rules: x gathered over the sequence once, the hidden kept
    ff-sharded on `model`, the output reduce-scattered back to
    sequence-sharded.  Without rules the constraints return their input.
    """
    if activation == "silu":
        act = F.silu
    elif activation == "gelu":
        def act(h):
            return F.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"activation={activation!r}: 'silu' or 'gelu'")
    if megatron:
        x = constrain(x, "batch", None, None)          # gather seq
    h = act(dense(params["wg"], x)) * dense(params["wi"], x)
    if megatron:
        h = constrain(h, "batch", None, "mlp_ff")      # ff stays sharded
        return constrain(dense(params["wo"], h), "batch", "seq", None)
    return dense(params["wo"], h)


# ----------------------------------------------------------------------
# Rotary position embeddings
# ----------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float = 10_000.0, device="cpu"):
    """(head_dim/2,) inverse frequencies, computed in f32 as the reference
    does (float64 differs visibly at theta = 5e6)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # a Python-scalar base: no host-to-device copy (which would stall the
    # host behind the card) and the power is taken in f32
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    inv = rope_frequencies(x.shape[-1], theta, device=x.device)
    ang = positions[..., :, None].float() * inv          # (..., S, hd/2)
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# Embeddings
# ----------------------------------------------------------------------
def init_embedding(gen, vocab: int, d_model: int, *, dtype=torch.float32,
                   device="cpu"):
    return {"table": _normal(gen, (vocab, d_model), 0.02, dtype, device)}


def embed(params, tokens):
    table = params["table"]
    rows = table.index_select(0, tokens.reshape(-1))
    return rows.reshape(*tokens.shape, table.shape[-1])
