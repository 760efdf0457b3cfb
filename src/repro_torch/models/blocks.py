"""Decoder blocks for every ``arch_type`` the reference's block dispatch
takes ("dense", "vlm", "audio", "encdec", "moe", "ssm", "hybrid"):
prefill and decode paths, from ``repro/models/blocks.py``, with Gemma-2's
branches (per-layer sliding windows from ``window_pattern`` /
``global_layers``, the attention soft-cap, the post-norms ``pn1`` /
``pn2``), Qwen3's ``qk_norm``, the moe branch (``ln2`` and ``moe`` in
place of ``mlp``; the block returns the layer's load-balance aux, which
decode drops), the ssm block (the Mamba-2 mixer alone, no ``ln2``) and
Hymba's hybrid block (attention and the mixer side by side on ``ln1(x)``,
each normed by ``bn_*`` and scaled by ``beta_*``, then averaged).  The
vlm, audio and encdec types run the dense block, as the reference's
dispatch does (the encoder-decoder's own stacks are ``models/encdec.py``).

``check_supported`` raises ``NotImplementedError`` for any other
``arch_type``.  ``mlp_megatron`` (the prefill MLP's sharding
constraints), ``attn_kv_gather`` and ``attn_block_skip`` act as in the
reference (``layers.mlp``, ``attention.attention_block``) and change no
value.  ``embed_reshard`` and ``bf16_params_compute`` only change
sharding or the place of a cast in the reference, not its values, and are
accepted as they are; so is ``embed_onehot``, whose one-hot product picks
the embedding rows exactly.
"""
from __future__ import annotations

import torch

from .attention import (attention_block, decode_attention_block,
                        init_attention, init_kv_cache)
from .layers import init_mlp, init_rms_norm, mlp, rms_norm
from .mamba import (init_mamba, init_mamba_cache, mamba_decode_step,
                    mamba_mixer)
from .moe import init_moe, moe_layer

__all__ = ["init_block", "block_forward", "block_decode", "init_block_cache",
           "layer_windows", "check_supported", "GLOBAL_WINDOW", "BLOCK_ARCHS"]

GLOBAL_WINDOW = (2**31 - 1) // 2   # "no window", as the reference's int32

# the arch types of the reference's block dispatch
BLOCK_ARCHS = ("dense", "vlm", "audio", "encdec", "moe", "ssm", "hybrid")


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for an ``arch_type`` that has no
    block (the CNN's, say), ``ValueError`` for heads that do not group."""
    if cfg.arch_type not in BLOCK_ARCHS:
        raise NotImplementedError(
            f"arch_type={cfg.arch_type!r} has no LM block: the blocks are "
            f"{', '.join(BLOCK_ARCHS)}")
    if cfg.num_heads % max(cfg.num_kv_heads, 1):
        raise ValueError("num_heads must be a multiple of num_kv_heads")


def layer_windows(cfg, num_layers=None):
    """Per-layer sliding-window sizes, one int per layer.

    Gemma-2 style: with ``window_pattern`` p, every p-th layer is global
    (``GLOBAL_WINDOW``) and the others use ``sliding_window``; explicit
    ``global_layers`` take precedence.  Without either, every layer uses
    ``sliding_window``, or full attention when it is 0.
    """
    L = num_layers if num_layers is not None else cfg.num_layers
    if cfg.sliding_window <= 0:
        return (GLOBAL_WINDOW,) * L
    if cfg.global_layers:
        glob = set(cfg.global_layers)
        return tuple(GLOBAL_WINDOW if i in glob else cfg.sliding_window
                     for i in range(L))
    if cfg.window_pattern > 0:
        p = cfg.window_pattern
        return tuple(GLOBAL_WINDOW if i % p == p - 1 else cfg.sliding_window
                     for i in range(L))
    return (cfg.sliding_window,) * L


def init_block(gen, cfg, *, stack=(), dtype=torch.float32, device="cpu"):
    """One layer's params, every leaf with ``stack`` prepended."""
    check_supported(cfg)
    d, t = cfg.d_model, cfg.arch_type
    kw = dict(stack=stack, dtype=dtype, device=device)
    p = {"ln1": init_rms_norm(d, **kw)}
    if t != "ssm":
        p["attn"] = init_attention(gen, d, cfg.num_heads, cfg.num_kv_heads,
                                   cfg.head_dim, qk_norm=cfg.qk_norm, **kw)
    if t in ("ssm", "hybrid"):
        p["mamba"] = init_mamba(gen, d, cfg.ssm_heads, cfg.ssm_head_dim,
                                cfg.ssm_state, cfg.conv_kernel, **kw)
    if t == "hybrid":
        p["beta_attn"] = torch.ones((*stack, d), dtype=dtype, device=device)
        p["beta_ssm"] = torch.ones((*stack, d), dtype=dtype, device=device)
        p["bn_attn"] = init_rms_norm(d, **kw)
        p["bn_ssm"] = init_rms_norm(d, **kw)
    if t == "moe":
        p["ln2"] = init_rms_norm(d, **kw)
        p["moe"] = init_moe(gen, d, cfg.num_experts, cfg.expert_d_ff, **kw)
    elif t != "ssm" and cfg.d_ff > 0:
        p["ln2"] = init_rms_norm(d, **kw)
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, **kw)
    if cfg.post_norm:
        p["pn1"] = init_rms_norm(d, **kw)
        if "ln2" in p:
            p["pn2"] = init_rms_norm(d, **kw)
    return p


def block_forward(params, x, positions, cfg, window=None,
                  collect_cache: bool = False, cache_dtype=torch.bfloat16):
    """Prefill path.  Returns (x, cache_or_kv, aux): with
    ``collect_cache`` the middle value is this layer's decode cache in
    ``init_block_cache``'s layout (``"kv"``: post-rope k/v cast to
    ``cache_dtype``; ``"mamba"``: the mixer's state and conv tail),
    otherwise the raw (k, v), or None for the ssm block."""
    h = rms_norm(params["ln1"], x, cfg.norm_eps)
    kv, blk_cache, t = None, {}, cfg.arch_type
    if t in ("ssm", "hybrid"):
        ssm_out = mamba_mixer(params["mamba"], h, cfg,
                              return_cache=collect_cache,
                              cache_dtype=cache_dtype)
        if collect_cache:
            ssm_out, blk_cache["mamba"] = ssm_out
    if t == "hybrid":
        attn_out, kv = attention_block(params["attn"], h, positions, cfg,
                                       window=window)
        x = x + _hybrid_mix(params, attn_out, ssm_out, cfg, x.dtype)
    elif t == "ssm":
        x = x + ssm_out
    else:
        attn_out, kv = attention_block(params["attn"], h, positions, cfg,
                                       window=window)
        x = x + _post_norm(params, "pn1", attn_out, cfg)
    if collect_cache:
        if kv is not None:
            k, v = kv
            blk_cache["kv"] = {"k": k.to(cache_dtype), "v": v.to(cache_dtype)}
        kv = blk_cache
    x, aux = _ffn_residual(params, x, cfg, megatron=cfg.mlp_megatron)
    return x, kv, aux


def _hybrid_mix(params, attn_out, ssm_out, cfg, dt):
    """Hymba's residual update: each branch normed by ``bn_*`` and scaled
    by ``beta_*`` (cast to the residual's dtype ``dt``), then averaged."""
    attn_out = rms_norm(params["bn_attn"], attn_out, cfg.norm_eps) \
        * params["beta_attn"].to(dt)
    ssm_out = rms_norm(params["bn_ssm"], ssm_out, cfg.norm_eps) \
        * params["beta_ssm"].to(dt)
    return 0.5 * (attn_out + ssm_out)


def _post_norm(params, name, out, cfg):
    """Gemma-2's norm of a sublayer's output before the residual add."""
    return rms_norm(params[name], out, cfg.norm_eps) if cfg.post_norm \
        else out


def _ffn_residual(params, x, cfg, megatron: bool = False):
    """x plus the moe or mlp sublayer of ``ln2(x)``, and the moe's aux
    (0 otherwise).  ``megatron`` is the prefill MLP's (``layers.mlp``)."""
    if "moe" in params:
        h2 = rms_norm(params["ln2"], x, cfg.norm_eps)
        out, aux = moe_layer(params["moe"], h2, cfg)
        return x + out, aux
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "mlp" not in params:
        return x, aux
    h2 = rms_norm(params["ln2"], x, cfg.norm_eps)
    return x + _post_norm(params, "pn2", mlp(params["mlp"], h2,
                                             cfg.activation,
                                             megatron=megatron), cfg), aux


def init_block_cache(batch, seq_len, cfg, *, stack=(), dtype=torch.bfloat16,
                     device="cpu"):
    """Per-layer decode cache, ``stack`` prepended (the layer axis):
    ``"kv"`` for every block with attention, ``"mamba"`` for the ssm and
    hybrid blocks."""
    c, t = {}, cfg.arch_type
    if t != "ssm":
        c["kv"] = init_kv_cache(batch, seq_len, cfg.num_kv_heads,
                                cfg.head_dim, stack=stack, dtype=dtype,
                                device=device)
    if t in ("ssm", "hybrid"):
        c["mamba"] = init_mamba_cache(batch, cfg, stack=stack, dtype=dtype,
                                      device=device)
    return c


def block_decode(params, x, cache, cache_len, cfg, window=None):
    """Single-token decode; updates ``cache`` in place.
    Returns (x, cache)."""
    h = rms_norm(params["ln1"], x, cfg.norm_eps)
    t = cfg.arch_type
    if t in ("ssm", "hybrid"):
        ssm_out, _ = mamba_decode_step(params["mamba"], h, cache["mamba"],
                                       cfg)
    if t == "hybrid":
        attn_out, _ = decode_attention_block(params["attn"], h, cache["kv"],
                                             cache_len, cfg, window=window)
        x = x + _hybrid_mix(params, attn_out, ssm_out, cfg, x.dtype)
    elif t == "ssm":
        x = x + ssm_out
    else:
        attn_out, _ = decode_attention_block(params["attn"], h, cache["kv"],
                                             cache_len, cfg, window=window)
        x = x + _post_norm(params, "pn1", attn_out, cfg)
    return _ffn_residual(params, x, cfg)[0], cache
