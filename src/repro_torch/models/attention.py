"""Grouped-query attention: the blockwise prefill path and the KV-cache
decode path, from ``repro/models/attention.py``.

Prefill runs the reference's ``chunked_attention`` (plain jnp there, not
a Pallas kernel; plain PyTorch here) with its chunk sizes, so the bf16
rounding of p, which follows the running max of each key chunk, is the
reference's.  Both paths take the sliding window (one int per layer)
and Gemma-2's attention soft-cap, and Qwen3's per-head q/k RMSNorm
(``qk_norm``) after the projections and before the rotary embedding.  The
prefill path also takes a cross-attention memory (``kv_source``, the
encoder-decoder's): k and v are projected from it and neither q nor k is
roped.

The reference's sharding constraints are kept (``core.shardlib``): with
no rules installed they return their input, so they change nothing
outside the dry-run.  ``attn_kv_gather`` picks which ones: q and the
output stay sequence-sharded and only k and v are gathered, instead of
the head-sharded layout.

``block_skip`` (``cfg.attn_block_skip``, on in the ``opt`` variant) skips
on the host every kv block that lies wholly outside the causal or window
band of a q chunk.  A skipped block after the last live one would add
``p = 0`` at ``alpha = 1``; one before the first live one would be wiped
by ``alpha = 0`` when the first live block comes, and every row has a
live key (itself).  So the result equals the unskipped path bit for bit.
``BLOCK_SKIPS["skipped"]`` counts the blocks skipped since the last
``reset_block_skips()``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.shardlib import constrain

from .layers import (apply_rope, dense, init_dense, init_rms_norm, rms_norm,
                     softcap)

__all__ = ["init_attention", "project_qkv", "chunked_attention",
           "attention_block", "init_kv_cache", "decode_attention_block",
           "write_kv", "NEG_INF", "BLOCK_SKIPS", "reset_block_skips",
           "live_block"]

NEG_INF = -1e30

# kv blocks ``chunked_attention(block_skip=True)`` skipped
BLOCK_SKIPS = {"skipped": 0}


def reset_block_skips() -> None:
    BLOCK_SKIPS["skipped"] = 0


def live_block(q_first: int, q_last: int, k_first: int, k_last: int, *,
               causal: bool, window) -> bool:
    """Whether a (q chunk, kv block) pair holds any unmasked score: not
    wholly after the chunk's last row (causal), not wholly at or past
    the window behind its first row.  Python ints throughout."""
    if causal and k_first > q_last:
        return False
    return not (window and k_last <= q_first - int(window))


def init_attention(gen, d_model: int, num_heads: int, num_kv_heads: int,
                   head_dim: int, *, stack=(), dtype=torch.float32,
                   device="cpu", qk_norm: bool = False):
    kw = dict(stack=stack, dtype=dtype, device=device)
    p = {
        "wq": init_dense(gen, d_model, num_heads * head_dim, **kw),
        "wk": init_dense(gen, d_model, num_kv_heads * head_dim, **kw),
        "wv": init_dense(gen, d_model, num_kv_heads * head_dim, **kw),
        "wo": init_dense(gen, num_heads * head_dim, d_model, **kw),
    }
    if qk_norm:
        p["q_norm"] = init_rms_norm(head_dim, **kw)
        p["k_norm"] = init_rms_norm(head_dim, **kw)
    return p


QK_NORM_EPS = 1e-6     # the reference's ``_headwise_rms``: not cfg.norm_eps


def _qk_norm(params, q, k):
    """Qwen3's per-head RMSNorm of q and k over ``head_dim`` (identity
    without ``q_norm``): K9's function, so ``ops.rmsnorm`` on rows of
    head_dim."""
    if "q_norm" not in params:
        return q, k
    return (rms_norm(params["q_norm"], q, QK_NORM_EPS),
            rms_norm(params["k_norm"], k, QK_NORM_EPS))


def _scale(D: int) -> float:
    """1 / sqrt(D) rounded to f32, as the reference computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(D)))


def chunked_attention(q, k, v, *, causal: bool = True, window=None,
                      attn_softcap: float = 0.0, q_chunk: int = 512,
                      k_chunk: int = 1024, block_skip: bool = False):
    """Blockwise online-softmax GQA attention.  q (B, Sq, H, D), k and v
    (B, Sk, KH, D) -> (B, Sq, H, D) in q's dtype.

    ``window`` None or 0 is full attention, else token i attends to j in
    (i - window, i].  Scores and the running max, sum and accumulator are
    f32; p is cast to v's dtype before the PV product, as the reference
    does.  ``block_skip`` skips the kv blocks ``live_block`` rules out
    (the chunks' real, ragged bounds) and counts them in ``BLOCK_SKIPS``.
    """
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = _scale(D)
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)
    nq, nk = -(-Sq // q_chunk), -(-Sk // k_chunk)
    win = int(window) if window else None
    dev = q.device
    k_range = torch.arange(k_chunk, device=dev)
    q_range = torch.arange(q_chunk, device=dev)
    outs = []
    for qi in range(nq):
        q_blk = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        rows = q_blk.shape[1]
        q_blk = q_blk.reshape(B, rows, KH, G, D).float()
        q_pos = qi * q_chunk + q_range[:rows]
        acc = torch.zeros((B, rows, KH, G, D), dtype=torch.float32,
                          device=dev)
        m = torch.full((B, rows, KH, G), NEG_INF, dtype=torch.float32,
                       device=dev)
        lsum = torch.zeros((B, rows, KH, G), dtype=torch.float32, device=dev)
        for ki in range(nk):
            if block_skip and not live_block(
                    qi * q_chunk, qi * q_chunk + rows - 1, ki * k_chunk,
                    min((ki + 1) * k_chunk, Sk) - 1, causal=causal,
                    window=win):
                BLOCK_SKIPS["skipped"] += 1
                continue
            k_blk = k[:, ki * k_chunk:(ki + 1) * k_chunk]
            v_blk = v[:, ki * k_chunk:(ki + 1) * k_chunk]
            k_pos = ki * k_chunk + k_range[:k_blk.shape[1]]
            s = torch.einsum("bqhgd,bkhd->bqhgk", q_blk,
                             k_blk.float()) * scale
            if attn_softcap:
                s = softcap(s, attn_softcap)
            mask = torch.ones((rows, k_blk.shape[1]), dtype=torch.bool,
                              device=dev)
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if win is not None:
                mask = mask & (q_pos[:, None] - k_pos[None, :] < win)
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            lsum = lsum * alpha + p.sum(dim=-1)
            pv = torch.einsum("bqhgk,bkhd->bqhgd", p.to(v.dtype).float(),
                              v_blk.float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / lsum.clamp_min(1e-20)[..., None]
        outs.append(out.to(q.dtype).reshape(B, rows, H, D))
    return torch.cat(outs, dim=1) if nq > 1 else outs[0]


def project_qkv(params, x, positions, cfg, kv_source=None):
    """The q, k, v projections of x (B, S, d_model): q (B, S, H, D), k and
    v (B, Sk, KH, D).  Self-attention (``kv_source`` None) projects k and
    v from x (Sk = S) and ropes q and k at ``positions``; cross-attention
    projects them from the memory ``kv_source`` (B, Sk, d_model) and ropes
    neither, as the reference does."""
    B, S, _ = x.shape
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    src = x if kv_source is None else kv_source
    Sk = src.shape[1]
    q = dense(params["wq"], x).reshape(B, S, H, D)
    k = dense(params["wk"], src).reshape(B, Sk, KH, D)
    v = dense(params["wv"], src).reshape(B, Sk, KH, D)
    q, k = _qk_norm(params, q, k)
    if kv_source is not None:
        return q, k, v
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def attention_block(params, x, positions, cfg, *, window=None,
                    causal: bool = True, kv_source=None):
    """Attention over a whole prompt.  x: (B, S, d_model); ``kv_source``:
    a cross-attention memory (B, Sk, d_model) or None (self-attention).
    Returns (out (B, S, d_model), (k, v) (B, Sk, KH, D), post-rope in
    self-attention)."""
    B, S, _ = x.shape
    q, k, v = project_qkv(params, x, positions, cfg, kv_source)
    if cfg.attn_kv_gather:
        # q and the attention output stay sequence-sharded; only K/V
        # (kv_dim << d_model under GQA) are gathered to the full sequence
        q = constrain(q, "batch", "seq", None, None)
        k = constrain(k, "batch", None, None, None)
        v = constrain(v, "batch", None, None, None)
    else:
        # the SP<->TP boundary: attention runs head-sharded, so its chunk
        # loops are collective-free (the all-to-all lives here, per layer)
        q = constrain(q, "batch", None, "heads", None)
        k = constrain(k, "batch", None, "kv_heads", None)
        v = constrain(v, "batch", None, "kv_heads", None)
    out = chunked_attention(q, k, v, causal=causal, window=window,
                            attn_softcap=cfg.attn_softcap,
                            q_chunk=cfg.attn_q_chunk or 512,
                            k_chunk=cfg.attn_k_chunk or 1024,
                            block_skip=cfg.attn_block_skip)
    out = constrain(out, "batch", "seq", None, None) if cfg.attn_kv_gather \
        else constrain(out, "batch", None, "heads", None)
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return dense(params["wo"], out), (k, v)


def init_kv_cache(batch: int, seq_len: int, num_kv_heads: int,
                  head_dim: int, *, stack=(), dtype=torch.bfloat16,
                  device="cpu"):
    shape = (*stack, batch, seq_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_kv(ck, cv, k, v, lens) -> None:
    """Write each row's new k, v (B, 1, KH, D) IN PLACE into the cache
    ck, cv (B, S, KH, D) at its own position ``lens[b]``; a row whose
    length has reached S writes nothing (the reference's one-hot select,
    done as an ``index_put`` that rewrites the old value there)."""
    B, S = ck.shape[:2]
    rows = torch.arange(B, device=ck.device)
    at = lens.clamp(max=S - 1).long()
    live = (lens < S)[:, None, None]
    ck[rows, at] = torch.where(live, k[:, 0].to(ck.dtype), ck[rows, at])
    cv[rows, at] = torch.where(live, v[:, 0].to(cv.dtype), cv[rows, at])


def _cache_contract(eq, a, b):
    """One of a decode step's contractions with the cache (the scores,
    then p @ v): ``torch.einsum`` in f32."""
    return torch.einsum(eq, a.float(), b.float())


def decode_attention_block(params, x, cache, cache_len, cfg, *, window=None):
    """One new token per row against a KV cache.

    x: (B, 1, d_model); cache k/v: (B, S, KH, D); cache_len: (B,) int
    per-row counts of valid tokens (or a scalar).  Each row's new k/v is
    written IN PLACE by ``write_kv``.  Returns (out (B, 1, d_model),
    cache).
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
    q, k = _qk_norm(params, q, k)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)

    write_kv(ck, cv, k, v, lens)

    s = _cache_contract("bhgd,bkhd->bhgk", q.reshape(B, KH, G, D),
                        ck) / float(np.sqrt(np.float32(D)))
    if cfg.attn_softcap:
        s = softcap(s, cfg.attn_softcap)
    k_pos = torch.arange(S, device=x.device)
    mask = k_pos[None, :] <= lens[:, None]
    if window is not None:
        mask = mask & (lens[:, None] - k_pos[None, :] < int(window))
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = _cache_contract("bhgk,bkhd->bhgd", p.to(cv.dtype), cv)
    out = dense(params["wo"], o.reshape(B, 1, H * D).to(x.dtype))
    return out, cache
