"""Encoder-decoder transformer (the SeamlessM4T-v2 backbone,
arXiv:2308.11596), from ``repro/models/encdec.py``.

The speech front end (mel + conformer feature extractor) is a stub: the
encoder takes precomputed frame embeddings (B, S_enc, d_model) and
projects them by ``frontend_proj`` through ``layers.dense`` (so through
the dense kernel; the vlm path's projector is a plain product).  The
encoder is non-causal self-attention blocks (roped); the decoder is
causal self-attention, cross-attention over the encoder's memory (not
roped) and the gated MLP.  The reference's ``lax.scan`` over the stacked
layers is a Python loop over layer slices here, as in ``lm.py``.

Serving: ``init_encdec_cache`` holds each decoder layer's self-attention
KV cache and the K/V of the memory for its cross-attention.  Nothing here
fills ``cross_k`` / ``cross_v``, as nothing in the reference does: the
caller projects the memory through each layer's ``cross_attn`` ``wk`` and
``wv``.  The cache has no lengths; ``encdec_decode_step`` takes
``cache_len`` explicitly and writes the self-attention cache in place, so
the cache it returns is the one it was given.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device

from .attention import (attention_block, decode_attention_block,
                        init_attention, init_kv_cache)
from .blocks import check_supported
from .layers import (dense, embed, init_dense, init_embedding, init_mlp,
                     init_rms_norm, mlp, rms_norm)
from .lm import chunked_cross_entropy, init_device, layer_params

__all__ = ["init_encdec_params", "embed_tokens", "encode",
           "encdec_forward", "encdec_loss_fn", "init_encdec_cache",
           "encdec_decode_step"]


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _attention(gen, cfg, kw):
    return init_attention(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim, **kw)


def init_encdec_params(cfg, generator, device="cuda"):
    """Random params in the reference's tree layout, drawn from
    ``generator`` on ``device`` (``lm.init_device``: ``"meta"`` builds
    shapes only).  ``encoder`` and ``decoder`` leaves carry a leading
    layer axis."""
    check_supported(cfg)
    dev = init_device(generator, device)
    pdt = torch.float32 if cfg.param_dtype == "float32" else torch.bfloat16
    kw = dict(dtype=pdt, device=dev)
    d = cfg.d_model
    enc = dict(kw, stack=(cfg.num_encoder_layers,))
    dec = dict(kw, stack=(cfg.num_layers,))
    return {
        "frontend_proj": init_dense(generator, d, d, **kw),
        "embed": init_embedding(generator, cfg.vocab_size, d, **kw),
        "encoder": {
            "ln1": init_rms_norm(d, **enc),
            "attn": _attention(generator, cfg, enc),
            "ln2": init_rms_norm(d, **enc),
            "mlp": init_mlp(generator, d, cfg.d_ff, **enc),
        },
        "enc_norm": init_rms_norm(d, **kw),
        "decoder": {
            "ln1": init_rms_norm(d, **dec),
            "self_attn": _attention(generator, cfg, dec),
            "lnx": init_rms_norm(d, **dec),
            "cross_attn": _attention(generator, cfg, dec),
            "ln2": init_rms_norm(d, **dec),
            "mlp": init_mlp(generator, d, cfg.d_ff, **dec),
        },
        "final_norm": init_rms_norm(d, **kw),
    }


def embed_tokens(params, tokens, cfg):
    return embed(params["embed"], tokens).to(_dtype(cfg))


def _positions(x):
    B, S, _ = x.shape
    return torch.arange(S, device=x.device)[None, :].expand(B, S)


def encode(params, frame_embeds, cfg):
    """frame_embeds: (B, S_enc, d_model) -> the encoder memory
    (B, S_enc, d_model) in the activation dtype."""
    eps = cfg.norm_eps
    x = dense(params["frontend_proj"], frame_embeds.to(_dtype(cfg)))
    pos = _positions(x)
    for i in range(cfg.num_encoder_layers):
        lp = layer_params(params["encoder"], i)
        h = rms_norm(lp["ln1"], x, eps)
        a, _ = attention_block(lp["attn"], h, pos, cfg, causal=False)
        x = x + a
        h = rms_norm(lp["ln2"], x, eps)
        x = x + mlp(lp["mlp"], h, cfg.activation)
    return rms_norm(params["enc_norm"], x, eps)


def _decode_stack(params, x, memory, cfg):
    """The decoder over embedded text x (B, S, d_model) against
    ``memory``: the hidden state after the final norm."""
    eps = cfg.norm_eps
    pos = _positions(x)
    for i in range(cfg.num_layers):
        lp = layer_params(params["decoder"], i)
        h = rms_norm(lp["ln1"], x, eps)
        a, _ = attention_block(lp["self_attn"], h, pos, cfg, causal=True)
        x = x + a
        h = rms_norm(lp["lnx"], x, eps)
        c, _ = attention_block(lp["cross_attn"], h, pos, cfg, causal=False,
                               kv_source=memory)
        x = x + c
        h = rms_norm(lp["ln2"], x, eps)
        x = x + mlp(lp["mlp"], h, cfg.activation)
    return rms_norm(params["final_norm"], x, eps)


def encdec_forward(params, frame_embeds, tokens, cfg):
    memory = encode(params, frame_embeds, cfg)
    return _decode_stack(params, embed_tokens(params, tokens, cfg), memory,
                         cfg)


def encdec_loss_fn(params, batch, cfg):
    """batch: {'frontend_embeds' (B, S_enc, d), 'tokens' (B, S), 'labels'
    (B, S)}.  The tied table is the head.  Returns (ce, {'ce', 'aux': 0})."""
    hidden = encdec_forward(params, batch["frontend_embeds"],
                            batch["tokens"], cfg)
    ce = chunked_cross_entropy(hidden, params["embed"]["table"],
                               batch["labels"], cfg)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=ce.device)}


# ----------------------------------------------------------------------
# Serving: the self-attention KV cache and the precomputed cross K/V
# ----------------------------------------------------------------------
def init_encdec_cache(cfg, batch: int, max_seq: int, enc_len: int,
                      dtype=torch.bfloat16, device="cuda"):
    """Per decoder layer (a leading L axis): ``kv`` {k, v} (L, B, max_seq,
    KH, D) and ``cross_k`` / ``cross_v`` (L, B, enc_len, KH, D), zeros, on
    ``device`` (``"cuda"`` by default; ``"cpu"``, or ``"meta"`` for shapes
    only)."""
    dev = resolve_device(device, meta=True)
    KH, D, L = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    cross = (L, batch, enc_len, KH, D)
    return {
        "kv": init_kv_cache(batch, max_seq, KH, D, stack=(L,), dtype=dtype,
                            device=dev),
        "cross_k": torch.zeros(cross, dtype=dtype, device=dev),
        "cross_v": torch.zeros(cross, dtype=dtype, device=dev),
    }


def encdec_decode_step(params, cache, cache_len, tokens, cfg):
    """One decoder token per row (tokens (B, 1)) against the
    self-attention cache, written in place at ``cache_len`` (a scalar or
    (B,) count), and the cross K/V over the whole memory.  The cross
    scores are f32 and divided by sqrt(D), their softmax f32, p cast to
    ``cross_v``'s dtype, as the reference computes them.  Returns
    (logits (B, 1, V) f32 over the tied table, cache)."""
    dt = _dtype(cfg)
    eps = cfg.norm_eps
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // KH
    x = embed_tokens(params, tokens, cfg)
    B = x.shape[0]
    root_d = float(np.sqrt(np.float32(D)))
    for i in range(cfg.num_layers):
        lp = layer_params(params["decoder"], i)
        lc = layer_params(cache, i)
        h = rms_norm(lp["ln1"], x, eps)
        a, _ = decode_attention_block(lp["self_attn"], h, lc["kv"], cache_len,
                                      cfg)
        x = x + a
        h = rms_norm(lp["lnx"], x, eps)
        q = dense(lp["cross_attn"]["wq"], h).reshape(B, KH, G, D)
        ck, cv = lc["cross_k"], lc["cross_v"]
        s = torch.einsum("bhgd,bkhd->bhgk", q.float(), ck.float()) / root_d
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgk,bkhd->bhgd", p.to(cv.dtype).float(),
                         cv.float()).to(cv.dtype)
        x = x + dense(lp["cross_attn"]["wo"], o.reshape(B, 1, H * D).to(dt))
        h = rms_norm(lp["ln2"], x, eps)
        x = x + mlp(lp["mlp"], h, cfg.activation)
    x = rms_norm(params["final_norm"], x, eps)
    logits = x @ params["embed"]["table"].to(dt).T
    return logits.float(), cache
