"""Decoder-only language model: init / forward / loss / prefill /
decode, from ``repro/models/lm.py``.

The reference's ``lax.scan`` over stacked layer params is a Python loop
here; every leaf of ``params["layers"]`` keeps the leading ``L`` axis.
The decode cache is updated in place (``decode_step``, ``cache_insert``
and ``cache_evict`` return the same tensors they were given), where the
reference builds new arrays; the values are the same.  The loss is the
reference's sequence-chunked cross-entropy: the (B, S, V) logits are
never held at once, and each chunk's logits are recomputed for the
backward.

A config with a ``frontend`` (the vlm InternVL2) takes precomputed
patch embeddings (B, P, d_model) in ``forward`` and ``loss_fn``: they are
projected by ``frontend_proj`` (a plain product in the reference, outside
any Pallas kernel, so ``torch.matmul`` here) and put before the text,
whose P front-end positions carry no loss.  The reference's embedding
flags ``embed_onehot`` (a one-hot product whose one nonzero term is the
looked-up row) and ``embed_reshard`` (a sharding constraint) give the
rows the plain lookup gives, so the lookup serves all three.

The reference's sharding constraints (``core.shardlib.constrain``) stand
where it has them: the embedded rows and every layer boundary
sequence-sharded, ``embed_reshard``'s d-sharded table and rows, the
loss chunks' logits vocab-sharded.  ``embed_onehot``'s constraint is on
the one-hot matrix, which the lookup never builds.  With no rules
installed each returns its input.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import resolve_device
from repro_torch.core.shardlib import constrain

from .blocks import (block_decode, block_forward, check_supported,
                     init_block, init_block_cache, layer_windows)
from .layers import (embed, init_dense, init_embedding, init_rms_norm,
                     rms_norm, softcap)

__all__ = ["init_params", "forward", "loss_fn", "chunked_cross_entropy",
           "DecodeCache", "init_cache", "prefill", "cache_insert",
           "cache_evict", "decode_step", "compute_params", "layer_params",
           "init_device"]


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def init_device(generator, device) -> torch.device:
    """The device params are drawn on: ``"meta"`` builds shapes only and
    takes ``generator=None``; ``"cuda"`` or ``"cpu"`` needs an explicit
    ``torch.Generator`` of that device type."""
    dev = resolve_device(device, meta=True)
    if dev.type != "meta":
        if not isinstance(generator, torch.Generator):
            raise TypeError("init_params needs an explicit torch.Generator")
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device} cannot draw "
                             f"params on {dev}")
    return dev


def init_params(cfg, generator, device="cuda"):
    """Random params in the reference's tree layout, drawn from
    ``generator`` on ``device`` (``init_device``)."""
    check_supported(cfg)
    dev = init_device(generator, device)
    pdt = torch.float32 if cfg.param_dtype == "float32" else torch.bfloat16
    kw = dict(dtype=pdt, device=dev)
    params = {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model, **kw),
        "layers": init_block(generator, cfg, stack=(cfg.num_layers,), **kw),
        "final_norm": init_rms_norm(cfg.d_model, **kw),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(generator, cfg.vocab_size,
                                           cfg.d_model, **kw)
    if cfg.frontend:
        # the stub modality projector (ViT / audio-codec outputs ->
        # d_model), w (d, d) x 1/sqrt(d); the reference draws it from
        # lm_head's key, the port from the same generator as the rest
        params["frontend_proj"] = init_dense(generator, cfg.d_model,
                                             cfg.d_model, **kw)
    return params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_stack(trees):
    """Stack a list of same-structured trees leaf by leaf on a new
    leading axis."""
    if isinstance(trees[0], dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def layer_params(layers, i: int):
    """Layer ``i`` of a stacked layer tree (views, no copies)."""
    return _tree_map(lambda t: t[i], layers)


_KEEP_DTYPE = ("conv_w",)       # compute_params' exception, by leaf name
# the trees whose leaves carry a leading layer axis (encdec.py's too)
_STACKED = ("layers", "encoder", "decoder")


def compute_params(params, cfg):
    """``params`` with every weight matrix cast once to the activation
    dtype: the floating leaves of >= 2 dims per layer (>= 3 in the stacked
    ``layers`` tree, and in the encoder-decoder's ``encoder`` and
    ``decoder``, whose leaves carry the leading ``L`` axis), the
    embedding and head tables and the front end's ``frontend_proj``.
    ``ops.dense``, the embedding, the lm-head and the front end cast to
    that dtype at every call, so the values are the same;
    holding the copy saves re-reading the f32 weights each step.  Norm
    scales and the mixer's per-head and per-channel vectors (``A_log``,
    ``D``, ``dt_bias``, ``conv_b``, ``norm_scale``), 1-D per layer, stay
    as they are: they are read in f32 or cast at the point of use.  So
    does the mixer's conv filter ``conv_w`` (k, Cd): its decode step casts
    it to the cache's dtype, which may be f32 in a bf16 model, and a bf16
    copy would round it first."""
    dt = _dtype(cfg)

    def cast(tree, min_ndim):
        if isinstance(tree, dict):
            return {k: tree[k] if k in _KEEP_DTYPE else cast(tree[k],
                                                             min_ndim)
                    for k in tree}
        return tree.to(dt) if tree.is_floating_point() and \
            tree.ndim >= min_ndim else tree
    return {k: cast(v, 3 if k in _STACKED else 2) for k, v in params.items()}


def _head_table(params):
    return params.get("lm_head", params["embed"])["table"]


def _logits(params, x, cfg):
    """Head logits in the activation dtype, Gemma-2's final soft-cap
    applied there, then f32, as the reference orders them."""
    logits = x @ _head_table(params).to(_dtype(cfg)).T
    if cfg.final_softcap:
        logits = softcap(logits, cfg.final_softcap)
    return logits.float()


# ----------------------------------------------------------------------
def forward(params, tokens, cfg, frontend_embeds=None, collect_cache=False,
            remat=False, cache_dtype=torch.bfloat16):
    """tokens: (B, S_text) int; frontend_embeds: (B, P, d_model) or None.
    Returns (hidden (B, P + S_text, d), per-layer decode caches stacked on
    a leading L axis or None, aux_loss).

    ``remat`` recomputes each block's activations in the backward
    (``torch.utils.checkpoint``, non-reentrant): the counterpart of the
    reference's ``jax.checkpoint`` with ``nothing_saveable``, so only the
    blocks' inputs are kept."""
    check_supported(cfg)
    dt = _dtype(cfg)
    if cfg.embed_reshard:
        # the vocab-sharded table resharded d-sharded, so the lookup is
        # local to each shard
        x = embed({"table": constrain(params["embed"]["table"], None, "tp")},
                  tokens).to(dt)
        x = constrain(x, "batch", None, "tp")
    else:
        x = embed(params["embed"], tokens).to(dt)
    if frontend_embeds is not None:
        fe = torch.matmul(frontend_embeds.to(dt),
                          params["frontend_proj"]["w"].to(dt))
        x = torch.cat([fe, x], dim=1)
    B, S, _ = x.shape
    x = constrain(x, "batch", "seq", "embed")
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for i, win in enumerate(layer_windows(cfg)):
        lp = layer_params(params["layers"], i)

        def block(x, lp=lp, win=win):
            # sequence-sharded at the layer boundary (Megatron-SP style)
            x = constrain(x, "batch", "seq", "embed")
            x, kv, a = block_forward(lp, x, positions, cfg, window=win,
                                     collect_cache=collect_cache,
                                     cache_dtype=cache_dtype)
            return constrain(x, "batch", "seq", "embed"), kv, a
        x, kv, a = (checkpoint(block, x, use_reentrant=False) if remat
                    else block(x))
        aux = aux + a
        if collect_cache:
            caches.append(kv)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return x, _tree_stack(caches) if collect_cache else None, aux


def _ce_chunk(h, lbl, table, cap):
    """(sum of the chunk's token NLLs, its count of labels >= 0): logits
    in the activation dtype, soft-capped there, then f32."""
    logits = constrain(h @ table.T, "batch", None, "vocab")
    if cap:
        logits = softcap(logits, cap)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lbl.clamp_min(0).long()[..., None])[..., 0]
    valid = (lbl >= 0).float()
    return ((lse - gold) * valid).sum(), valid.sum()


def chunked_cross_entropy(hidden, head_table, labels, cfg, chunk: int = 0):
    """Mean CE over (B, S) without materialising (B, S, V) at once: the
    sequence in chunks of ``chunk`` (else ``cfg.ce_chunk``, else 512)
    positions, the last padded with label -1; a label < 0 is left out of
    the mean.  Each chunk is checkpointed, so its logits are recomputed
    in the backward, as the reference's ``jax.checkpoint`` does."""
    B, S, _ = hidden.shape
    chunk = min(chunk or cfg.ce_chunk or 512, S)
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    table = head_table.to(hidden.dtype)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        t, n = checkpoint(_ce_chunk, hidden[:, sl], labels[:, sl], table,
                          cfg.final_softcap, use_reentrant=False)
        tot = tot + t
        cnt = cnt + n
    return tot / cnt.clamp_min(1.0)


def loss_fn(params, batch, cfg, aux_weight: float = 0.01,
            remat: bool = False):
    """batch: {'tokens': (B, S), 'labels': (B, S)} int tensors and,
    for a config with a front end, 'frontend_embeds' (B, P, d_model), whose
    positions carry label -1.  Returns (ce + aux_weight x aux, {'ce',
    'aux'})."""
    fe = batch.get("frontend_embeds")
    hidden, _, aux = forward(params, batch["tokens"], cfg,
                             frontend_embeds=fe, remat=remat)
    labels = batch["labels"]
    if fe is not None:
        pad = labels.new_full((labels.shape[0], fe.shape[1]), -1)
        labels = torch.cat([pad, labels], dim=1)
    ce = chunked_cross_entropy(hidden, _head_table(params), labels, cfg)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# ----------------------------------------------------------------------
# Serving
# ----------------------------------------------------------------------
@dataclasses.dataclass
class DecodeCache:
    """Slot-major decode cache.

    ``layers``: ``init_block_cache``'s tree stacked on a leading L axis:
    ``{"kv": {"k", "v"}}`` with leaves (L, slots, S, KH, D) for a block
    with attention, ``{"mamba": {"ssm", "conv"}}`` with leaves (L, slots,
    H, P, N) f32 and (L, slots, k - 1, Cd) for the ssm and hybrid blocks.
    ``lengths``: (slots,) int32 valid-token counts; 0 marks a free slot.
    """
    layers: Any
    lengths: torch.Tensor


def init_cache(batch, max_seq, cfg, dtype=torch.bfloat16, device="cuda"):
    """Slot-major decode cache for ``batch`` slots of ``max_seq`` tokens
    (cfg last, as the reference's current signature), on ``device``:
    ``"cuda"`` by default, which raises without a card unless ``"cpu"``
    (or ``"meta"``, shapes only) is passed."""
    check_supported(cfg)
    device = resolve_device(device, meta=True)
    layers = init_block_cache(batch, max_seq, cfg, stack=(cfg.num_layers,),
                              dtype=dtype, device=device)
    return DecodeCache(layers=layers,
                       lengths=torch.zeros((batch,), dtype=torch.int32,
                                           device=device))


def prefill(params, tokens, cfg, cache_dtype=torch.bfloat16):
    """Whole-prompt prefill as one forward pass.

    tokens: (B, P) int.  Returns (last-position logits (B, 1, V) f32,
    DecodeCache whose kv seq dim is P and whose lengths are all P): the
    state P ``decode_step`` calls would build.
    """
    hidden, layers, _ = forward(params, tokens, cfg, collect_cache=True,
                                cache_dtype=cache_dtype)
    B, P = tokens.shape
    logits = _logits(params, hidden[:, -1:], cfg)
    return logits, DecodeCache(
        layers=layers, lengths=torch.full((B,), P, dtype=torch.int32,
                                          device=tokens.device))


def cache_insert(cache, slice_, slot, row=0):
    """Copy row ``row`` of a prefill ``slice_`` into ``slot`` of a serving
    cache, in place.  Kv leaves land at positions [0, P); past them the
    stale payload is masked out by ``lengths``.  The mamba leaves have no
    sequence axis and are copied whole, as the reference's
    ``dynamic_update_slice`` copies them."""
    def upd(big, small):
        if isinstance(big, dict):
            for name, leaf in big.items():
                upd(leaf, small[name])
        else:
            big[:, slot, :small.shape[2]] = small[:, row].to(big.dtype)

    upd(cache.layers, slice_.layers)
    cache.lengths[slot] = slice_.lengths[row]
    return cache


def cache_evict(cache, slot):
    """Free ``slot``: zero its length so decode masks it out entirely."""
    cache.lengths[slot] = 0
    return cache


def decode_step(params, cache, cache_len, tokens, cfg):
    """tokens: (B, 1) int; cache: DecodeCache, updated in place.

    ``cache_len=None`` uses ``cache.lengths``: every occupied slot decodes
    at its own position and its length auto-increments (free slots stay
    0).  Otherwise a scalar or (B,) count is used as-is and the lengths
    pass through unchanged.  Returns (logits (B, 1, V) f32, cache).
    """
    if not isinstance(cache, DecodeCache):
        raise TypeError("decode_step takes a DecodeCache")
    check_supported(cfg)
    auto = cache_len is None
    if auto:
        cache_len = cache.lengths
    x = embed(params["embed"], tokens).to(_dtype(cfg))
    for i, win in enumerate(layer_windows(cfg)):
        lp = layer_params(params["layers"], i)
        lc = layer_params(cache.layers, i)
        x, _ = block_decode(lp, x, lc, cache_len, cfg, window=win)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = _logits(params, x, cfg)
    if auto:
        lengths = cache.lengths
        lengths += (lengths > 0).to(lengths.dtype)
    return logits, cache
