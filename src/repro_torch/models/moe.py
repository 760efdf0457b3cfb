"""Mixture-of-Experts layer with top-k routing, from ``repro/models/moe.py``.

Dispatch is sort-based and per batch row, as in the reference: each row's
token copies are sorted by expert id, written into a padded (E, C)
capacity buffer, run through a batched expert product and combined back
weighted by the router probability.  Keeping the dispatch per row means a
free or foreign slot under continuous batching never takes a row's
capacity.

Every step keeps the reference's values and order:

- the router product in x's dtype, the softmax in f32;
- top-k with the reference's tie rule (``jax.lax.top_k``: on equal
  probabilities the lower expert index first), from a stable descending
  sort; ``torch.topk`` breaks ties otherwise;
- the per-row capacity ``C = max(1, int(S * k * capacity_factor / E))``
  in Python floats, in the reference's order of operations;
- every expert runs on all C of its capacity rows, the empty ones too;
- each token's k weighted copies are added in increasing expert id (the
  order in which the reference's scatter meets them), rounding to x's
  dtype after each add; no ``index_add_`` or atomics, so a forward on
  the card reruns bit for bit.

The reference's sharding constraints stand where it has them
(``core.shardlib``): x gathered over the sequence before the dispatch
gather, the capacity buffer and the experts' output expert- (or
capacity-) sharded.  With no rules installed they return their input.
The router and the expert products are library calls here, as they are
``jnp`` products outside any Pallas kernel there.

The forward's four parts run under ``torch.profiler.record_function``
spans (``SPANS``), so a trace books their kernels to the router, the
dispatch, the experts' products and the combine.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.core.shardlib import constrain, constrain_div

from .layers import _normal, init_dense

__all__ = ["init_moe", "load_balance_loss", "top_k", "capacity", "route",
           "moe_layer", "SPANS"]

SPANS = ("moe.router", "moe.dispatch", "moe.experts", "moe.combine")


def init_moe(gen, d_model: int, num_experts: int, expert_d_ff: int, *,
             stack=(), dtype=torch.float32, device="cpu"):
    """Router (d, E) and the experts' wi, wg (E, d, f) and wo (E, f, d),
    ``stack`` prepended to every leaf."""
    E, d, f = num_experts, d_model, expert_d_ff
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    return {
        "router": init_dense(gen, d, E, stack=stack, dtype=dtype,
                             device=device),
        "wi": _normal(gen, (*stack, E, d, f), s_in, dtype, device),
        "wg": _normal(gen, (*stack, E, d, f), s_in, dtype, device),
        "wo": _normal(gen, (*stack, E, f, d), s_out, dtype, device),
    }


def load_balance_loss(probs, expert_mask):
    """Switch-style aux loss: E * sum_e f_e * p_e.

    probs: (B, S, E) router softmax; expert_mask: (B, S, E) 0/1 top-k
    hits."""
    E = probs.shape[-1]
    f = expert_mask.mean(dim=(0, 1))          # fraction routed
    p = probs.mean(dim=(0, 1))                # mean router prob
    return E * (f * p).sum()


def top_k(probs, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index as ``jax.lax.top_k`` breaks them: a stable descending
    sort, cut to k."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(S: int, k: int, capacity_factor: float, E: int) -> int:
    """Per-row capacity, in the reference's Python-float order."""
    return max(1, int(S * k * capacity_factor / E))


def route(params, x, cfg, capacity_factor: float = 0.0):
    """The router and the per-row dispatch of x (B, S, d).  Returns a dict:
    ``probs`` (B, S, E) f32, ``top_e`` / ``top_p`` (B, S, k) (top_p
    renormalised), ``aux``, and per row in expert-sorted order of its
    S * k copies: ``order`` (the copy each position holds), ``keep``,
    ``slot`` (in [0, E * C], E * C the trash slot of a dropped copy),
    ``src_tok``; and ``C``."""
    capacity_factor = capacity_factor or cfg.moe_capacity_factor
    B, S, _ = x.shape
    E, k = cfg.num_experts, cfg.top_k
    with record_function("moe.router"):
        logits = x @ params["router"]["w"].to(x.dtype)          # (B, S, E)
        probs = torch.softmax(logits.float(), dim=-1)
        top_p, top_e = top_k(probs, k)
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
        expert_mask = F.one_hot(top_e, E).to(torch.float32).sum(dim=2)
        aux = load_balance_loss(probs, expert_mask)

    T = S * k
    C = capacity(S, k, capacity_factor, E)
    with record_function("moe.dispatch"):
        flat_e = top_e.reshape(B, T)
        order = torch.argsort(flat_e, dim=-1, stable=True)
        sorted_e = flat_e.gather(-1, order)
        # each expert's segment start in the sorted copies, and a copy's
        # rank within its expert's segment
        starts = torch.searchsorted(sorted_e, torch.arange(
            E, device=x.device).expand(B, E).contiguous())
        ranks = torch.arange(T, device=x.device) - starts.gather(-1,
                                                                 sorted_e)
        keep = ranks < C
        slot = torch.where(keep, sorted_e * C + ranks, E * C)
    return {"probs": probs, "top_e": top_e, "top_p": top_p, "aux": aux,
            "order": order, "keep": keep, "slot": slot,
            "src_tok": torch.div(order, k, rounding_mode="floor"), "C": C}


def _activation(name):
    if name == "silu":
        return F.silu
    # jax.nn.gelu's default is the tanh form
    return lambda h: F.gelu(h, approximate="tanh")


def moe_layer(params, x, cfg, capacity_factor: float = 0.0):
    """x: (B, S, d_model) -> (out in x's dtype, aux_loss f32)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    r = route(params, x, cfg, capacity_factor)
    C, slot, keep, order = r["C"], r["slot"], r["keep"], r["order"]
    T = S * k

    # dispatch: each kept slot receives exactly one token copy; dropped
    # copies all land in the trash slot E * C, which is cut off unread
    with record_function("moe.dispatch"):
        # gather x before the k-fold copy expansion, so a sharded x moves
        # once, not k times
        x_full = constrain(x, "batch", None, None)
        xv = x_full.gather(1, r["src_tok"][..., None].expand(B, T, d))
        buf = x.new_zeros((B, E * C + 1, d)).scatter(
            1, slot[..., None].expand(B, T, d), xv)
        buf = buf[:, :E * C].reshape(B, E, C, d)
        # the expert-parallel layout: the dispatch all-to-all lives here
        buf = constrain_div(buf, "batch", "expert", "capacity", None)

    # the experts, every capacity row of every expert, in x's dtype
    with record_function("moe.experts"):
        act = _activation(cfg.activation)
        h = act(torch.einsum("becd,edf->becf", buf,
                             params["wg"].to(x.dtype))) \
            * torch.einsum("becd,edf->becf", buf, params["wi"].to(x.dtype))
        y = torch.einsum("becf,efd->becd", h, params["wo"].to(x.dtype))
        y = constrain_div(y, "batch", "expert", "capacity", None)

    # combine: the copies back in token order (copy j of token s at s*k+j),
    # each weighted by where(keep, p, 0) in x's dtype, then each token's k
    # copies added in increasing expert id
    with record_function("moe.combine"):
        y = torch.cat([y.reshape(B, E * C, d), y.new_zeros((B, 1, d))],
                      dim=1)
        inv = torch.empty_like(order).scatter(1, order, torch.arange(
            T, device=x.device).expand(B, T).contiguous())
        tok_slot = slot.gather(1, inv)                           # (B, T)
        w = torch.where(keep.gather(1, inv), r["top_p"].reshape(B, T), 0.0)
        copies = y.gather(1, tok_slot[..., None].expand(B, T, d)) \
            * w.to(x.dtype)[..., None]
        by_expert = r["top_e"].argsort(dim=-1)                   # (B, S, k)
        copies = copies.reshape(B, S, k, d).gather(
            2, by_expert[..., None].expand(B, S, k, d))
        out = x.new_zeros((B, S, d))
        for j in range(k):
            out = out + copies[:, :, j]
    return out, r["aux"]
