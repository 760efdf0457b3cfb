"""Decoder block for ``arch_type="dense"``: prefill and decode paths, from
``repro/models/blocks.py``.

The moe, ssm and hybrid branches, and the config branches neither Yi-6B
nor Phi-3 uses, are not ported yet: ``check_supported`` raises
``NotImplementedError`` naming the branch.  ``mlp_megatron``,
``attn_block_skip`` and ``bf16_params_compute`` only change sharding,
skipping or the place of a cast in the reference, not its values, and
are accepted as they are.
"""
from __future__ import annotations

import torch

from .attention import (attention_block, decode_attention_block,
                        init_attention, init_kv_cache)
from .layers import init_mlp, init_rms_norm, mlp, rms_norm

__all__ = ["init_block", "block_forward", "block_decode", "init_block_cache",
           "layer_windows", "check_supported", "GLOBAL_WINDOW"]

GLOBAL_WINDOW = (2**31 - 1) // 2   # "no window", as the reference's int32

# config fields whose reference branch the port does not have yet
_UNPORTED_FLAGS = ("sliding_window", "attn_softcap", "final_softcap",
                   "post_norm", "qk_norm", "frontend", "embed_onehot",
                   "embed_reshard", "attn_kv_gather")


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a config this slice cannot run."""
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"arch_type={cfg.arch_type!r}: only the 'dense' block is ported "
            "(moe, ssm, hybrid, encdec, vlm and audio are not yet)")
    for flag in _UNPORTED_FLAGS:
        if getattr(cfg, flag):
            raise NotImplementedError(
                f"{cfg.name}: the {flag} branch is not ported yet")
    if cfg.num_heads % max(cfg.num_kv_heads, 1):
        raise ValueError("num_heads must be a multiple of num_kv_heads")


def layer_windows(cfg, num_layers=None):
    """Per-layer attention windows: ``GLOBAL_WINDOW`` for every layer
    (sliding windows are not ported)."""
    if cfg.sliding_window > 0:
        raise NotImplementedError(
            f"{cfg.name}: the sliding_window branch is not ported yet")
    L = num_layers if num_layers is not None else cfg.num_layers
    return (GLOBAL_WINDOW,) * L


def init_block(gen, cfg, *, stack=(), dtype=torch.float32, device="cpu"):
    """One dense layer's params, every leaf with ``stack`` prepended."""
    check_supported(cfg)
    d = cfg.d_model
    kw = dict(stack=stack, dtype=dtype, device=device)
    p = {"ln1": init_rms_norm(d, **kw),
         "attn": init_attention(gen, d, cfg.num_heads, cfg.num_kv_heads,
                                cfg.head_dim, **kw)}
    if cfg.d_ff > 0:
        p["ln2"] = init_rms_norm(d, **kw)
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, **kw)
    return p


def block_forward(params, x, positions, cfg, window=None,
                  collect_cache: bool = False, cache_dtype=torch.bfloat16):
    """Prefill path.  Returns (x, cache_or_kv, aux): with
    ``collect_cache`` the middle value is this layer's decode cache
    ``{"kv": {"k", "v"}}`` (post-rope k/v cast to ``cache_dtype``),
    otherwise the raw (k, v)."""
    h = rms_norm(params["ln1"], x, cfg.norm_eps)
    attn_out, kv = attention_block(params["attn"], h, positions, cfg,
                                   window=window)
    x = x + attn_out
    if collect_cache:
        k, v = kv
        kv = {"kv": {"k": k.to(cache_dtype), "v": v.to(cache_dtype)}}
    if "mlp" in params:
        h2 = rms_norm(params["ln2"], x, cfg.norm_eps)
        x = x + mlp(params["mlp"], h2, cfg.activation)
    return x, kv, torch.zeros((), dtype=torch.float32, device=x.device)


def init_block_cache(batch, seq_len, cfg, *, stack=(), dtype=torch.bfloat16,
                     device="cpu"):
    """Per-layer decode cache, ``stack`` prepended (the layer axis)."""
    return {"kv": init_kv_cache(batch, seq_len, cfg.num_kv_heads,
                                cfg.head_dim, stack=stack, dtype=dtype,
                                device=device)}


def block_decode(params, x, cache, cache_len, cfg, window=None):
    """Single-token decode; updates ``cache`` in place.
    Returns (x, cache)."""
    h = rms_norm(params["ln1"], x, cfg.norm_eps)
    attn_out, _ = decode_attention_block(params["attn"], h, cache["kv"],
                                         cache_len, cfg, window=window)
    x = x + attn_out
    if "mlp" in params:
        h2 = rms_norm(params["ln2"], x, cfg.norm_eps)
        x = x + mlp(params["mlp"], h2, cfg.activation)
    return x, cache
