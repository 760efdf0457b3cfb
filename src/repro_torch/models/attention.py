"""Grouped-query attention: the prefill path and the KV-cache decode path,
from ``repro/models/attention.py``.

Prefill replaces the reference's blockwise online softmax
(``chunked_attention``, plain jnp, not a Pallas kernel) with one masked
softmax over the whole key range, in the same form the reference takes
when the keys fit one block (Sk <= 1024, which covers every prompt the
serving path sees): unnormalised ``exp(s - max)`` cast to v's dtype
before the PV product, divided by the row sum afterwards.
"""
from __future__ import annotations

import numpy as np
import torch

from .layers import apply_rope, dense, init_dense

__all__ = ["init_attention", "attention_block", "init_kv_cache",
           "decode_attention_block", "NEG_INF"]

NEG_INF = -1e30


def init_attention(gen, d_model: int, num_heads: int, num_kv_heads: int,
                   head_dim: int, *, stack=(), dtype=torch.float32,
                   device="cpu"):
    kw = dict(stack=stack, dtype=dtype, device=device)
    return {
        "wq": init_dense(gen, d_model, num_heads * head_dim, **kw),
        "wk": init_dense(gen, d_model, num_kv_heads * head_dim, **kw),
        "wv": init_dense(gen, d_model, num_kv_heads * head_dim, **kw),
        "wo": init_dense(gen, num_heads * head_dim, d_model, **kw),
    }


def _masked_softmax_pv(s, mask, v):
    """s (…, Sk) f32 scores, mask broadcastable to s, v (B, Sk, KH, D) →
    f32 (B, Sq, KH, G, D) with p cast to v's dtype before the product."""
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    lsum = p.sum(dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o / lsum.clamp_min(1e-20)[..., None]


def attention_block(params, x, positions, cfg, *, window=None,
                    causal: bool = True):
    """Self-attention over a whole prompt.  x: (B, S, d_model).
    Returns (out (B, S, d_model), (k, v) post-rope (B, S, KH, D))."""
    B, S, _ = x.shape
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // KH
    q = dense(params["wq"], x).reshape(B, S, H, D)
    k = dense(params["wk"], x).reshape(B, S, KH, D)
    v = dense(params["wv"], x).reshape(B, S, KH, D)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    scale = float(np.float32(1.0) / np.sqrt(np.float32(D)))
    s = torch.einsum("bqhgd,bkhd->bqhgk", q.reshape(B, S, KH, G, D).float(),
                     k.float()) * scale
    pos = torch.arange(S, device=x.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=x.device)
    if causal:
        mask = mask & (pos[None, :] <= pos[:, None])
    if window is not None:
        mask = mask & (pos[:, None] - pos[None, :] < int(window))
    o = _masked_softmax_pv(s, mask[None, :, None, None, :], v)
    out = o.to(q.dtype).reshape(B, S, H * D)
    return dense(params["wo"], out), (k, v)


def init_kv_cache(batch: int, seq_len: int, num_kv_heads: int,
                  head_dim: int, *, stack=(), dtype=torch.bfloat16,
                  device="cpu"):
    shape = (*stack, batch, seq_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention_block(params, x, cache, cache_len, cfg, *, window=None):
    """One new token per row against a KV cache.

    x: (B, 1, d_model); cache k/v: (B, S, KH, D); cache_len: (B,) int
    per-row counts of valid tokens (or a scalar).  Each row's new k/v is
    written IN PLACE at its own position ``lens[b]``; a row whose length
    has reached S writes nothing (the reference's one-hot select, done as
    an ``index_put`` that rewrites the old value there).  Returns
    (out (B, 1, d_model), cache).
    """
    B = x.shape[0]
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // KH
    ck, cv = cache["k"], cache["v"]
    S = ck.shape[1]
    lens = torch.as_tensor(cache_len, dtype=torch.int32,
                           device=x.device).reshape(-1).expand(B)
    pos = lens[:, None]
    q = dense(params["wq"], x).reshape(B, 1, H, D)
    k = dense(params["wk"], x).reshape(B, 1, KH, D)
    v = dense(params["wv"], x).reshape(B, 1, KH, D)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)

    rows = torch.arange(B, device=x.device)
    at = lens.clamp(max=S - 1).long()
    live = (lens < S)[:, None, None]
    ck[rows, at] = torch.where(live, k[:, 0].to(ck.dtype), ck[rows, at])
    cv[rows, at] = torch.where(live, v[:, 0].to(cv.dtype), cv[rows, at])

    s = torch.einsum("bhgd,bkhd->bhgk", q.reshape(B, KH, G, D).float(),
                     ck.float()) / float(np.sqrt(np.float32(D)))
    k_pos = torch.arange(S, device=x.device)
    mask = k_pos[None, :] <= lens[:, None]
    if window is not None:
        mask = mask & (lens[:, None] - k_pos[None, :] < int(window))
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(cv.dtype).float(), cv.float())
    out = dense(params["wo"], o.reshape(B, 1, H * D).to(x.dtype))
    return out, cache
