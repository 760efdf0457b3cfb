"""Mamba-2 mixer through State-Space Duality (SSD, arXiv:2405.21060), from
``repro/models/mamba.py``.

The chunked SSD computes the within-chunk terms as a masked
attention-like product and the across-chunk terms as a recurrence over
per-chunk states; decode is the O(1) state update.  The scan, the causal
conv, the gated norm and the decode recurrence are library PyTorch ops
here, as they are ``jnp`` outside any Pallas kernel in the reference;
the in- and out-projections go through ``layers.dense`` (K1 forward,
K2/K3 backward on the card).

Each path keeps the reference's precisions, which differ between them:

- prefill runs the conv in x's dtype and gates in x's dtype after the
  f32 norm;
- decode runs the conv in the cache's dtype (bf16 by default, even for
  an f32 model) and gates in f32 before the cast;
- the SSD is f32 throughout, its output cast to x's dtype.

Prefill and decode therefore agree only at the reference's own
tolerances.  The causal conv is a shifted sum in tap order 0..k-1, not
``F.conv1d`` (another summation order, and TF32 under cuDNN).

One change from the reference, in the backward only: the within-chunk
decay ``exp(cum_i - cum_j)`` is masked to -inf above the diagonal before
the exponential, where the reference masks its result.  The forward
values are the same (``exp(-inf) = 0``); the reference's backward takes
``0 x exp(cum_i - cum_j)`` at the masked entries, which is NaN once a
chunk's decay passes f32's range (a sum of dt x |A| above 88), and so
are all its gradients then.

``decode_step`` writes the cache in place, as the port's attention
decode does.  Every part of the mixer runs under a
``torch.profiler.record_function`` span (``SPANS``), so a trace books its
kernels to the in-projection, the conv, the SSD, the gated norm and the
out-projection.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .layers import _normal, dense, init_dense

__all__ = ["init_mamba", "mamba_mixer", "mamba_decode_step",
           "init_mamba_cache", "ssd_chunked", "ssd_chunk_terms",
           "ssd_chunk_output", "ChunkTerms", "ssd_reference", "SPANS"]

SPANS = ("mamba.in_proj", "mamba.conv", "mamba.ssd", "mamba.gate_norm",
         "mamba.out_proj")
NORM_EPS = 1e-6                    # the gated norm's, not cfg.norm_eps


def init_mamba(gen, d_model: int, ssm_heads: int, ssm_head_dim: int,
               ssm_state: int, conv_kernel: int = 4, *, stack=(),
               dtype=torch.float32, device="cpu"):
    """The in-projection to [z (gate), x, B, C, dt] (one group), the
    depthwise conv, A_log = log(1..H), D, dt_bias, the gated norm's scale
    and the out-projection, ``stack`` prepended to every leaf."""
    H, P, N = ssm_heads, ssm_head_dim, ssm_state
    d_inner = H * P
    proj_dim = 2 * d_inner + 2 * N + H
    conv_dim = d_inner + 2 * N
    kw = dict(dtype=dtype, device=device)

    def const(row):
        return row.to(**kw).expand(*stack, row.shape[-1]).clone()
    in_proj = init_dense(gen, d_model, proj_dim, stack=stack, **kw)
    conv_w = _normal(gen, (*stack, conv_kernel, conv_dim), 0.1, dtype,
                     device)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((*stack, conv_dim), **kw),
        "A_log": const(torch.log(torch.linspace(1.0, float(H), H))),
        "D": torch.ones((*stack, H), **kw),
        "dt_bias": torch.zeros((*stack, H), **kw),
        "norm_scale": torch.ones((*stack, d_inner), **kw),
        "out_proj": init_dense(gen, d_inner, d_model, stack=stack, **kw),
    }


def _split_proj(zxbcdt, H, P, N):
    d_inner = H * P
    z = zxbcdt[..., :d_inner]
    x = zxbcdt[..., d_inner:2 * d_inner]
    B = zxbcdt[..., 2 * d_inner:2 * d_inner + N]
    C = zxbcdt[..., 2 * d_inner + N:2 * d_inner + 2 * N]
    dt = zxbcdt[..., 2 * d_inner + 2 * N:]
    return z, x, B, C, dt


# ----------------------------------------------------------------------
# SSD core
# ----------------------------------------------------------------------
def ssd_reference(x, dt, A, B, C, D):
    """The sequential O(L) recurrence (the tests' oracle).

    x: (b, L, H, P); dt: (b, L, H); A: (H,) < 0; B, C: (b, L, N); D: (H,).
    Returns y: (b, L, H, P) in x's dtype."""
    b, L, H, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, B, C))
    state = x.new_zeros((b, H, P, N), dtype=torch.float32)
    ys = []
    for t in range(L):
        dA = torch.exp(dtf[:, t] * A)                            # (b, H)
        dBx = (dtf[:, t, :, None] * xf[:, t])[..., None] \
            * Bf[:, t, None, None, :]
        state = state * dA[..., None, None] + dBx
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    y = torch.stack(ys, dim=1)
    return (y + xf * D[:, None]).to(x.dtype)


def ssd_chunked(x, dt, A, B, C, D, chunk: int = 256,
                return_final_state: bool = False):
    """The chunked SSD: ``ssd_reference``'s signature and values, with
    L / Q sequential steps, each a quadratic form over a Q-token chunk.

    ``return_final_state=True`` also returns the state after the last
    real token as (b, H, P, N) f32, ``init_mamba_cache``'s layout.  A
    ragged last chunk is padded with dt = 0: decay exp(0) = 1 and a zero
    injection, so the padded tail leaves the state as it was and the
    final carry is the length-L state.

    No temporary is larger than (b, nc, Q, Q, H) or x's size: the
    reference's three-operand contraction for the chunk states is taken
    as x scaled by its decay first, then one product over the chunk."""
    terms = ssd_chunk_terms(x, dt, A, B, C, min(chunk, x.shape[1]))
    y, state = ssd_chunk_output(x, D, terms, terms.states, terms.decays)
    if return_final_state:
        return y, state
    return y


class ChunkTerms(NamedTuple):
    """What the chunked SSD computes inside each chunk (``ssd_chunk_terms``),
    nc chunks of Q: nothing in it crosses a chunk."""
    y_intra: torch.Tensor       # (b, nc, Q, H, P) the intra-chunk output
    C: torch.Tensor             # (b, nc, Q, N) f32
    cum: torch.Tensor           # (b, nc, Q, H) within-chunk log-decay
    states: torch.Tensor        # (b, nc, H, N, P) each chunk's own state
    decays: torch.Tensor        # (b, nc, H) each chunk's whole decay


def ssd_chunk_terms(x, dt, A, B, C, Q):
    """The chunk-local terms of ``ssd_chunked`` over x (b, L, H, P), dt
    (b, L, H), B and C (b, L, N) cut into chunks of Q, a ragged last one
    padded with dt = 0."""
    b, L, H, P = x.shape
    N = B.shape[-1]
    nc = -(-L // Q)
    pad = nc * Q - L
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))

    xc = x.reshape(b, nc, Q, H, P).float()
    dtc = dt.reshape(b, nc, Q, H).float()
    Bc = B.reshape(b, nc, Q, N).float()
    Cc = C.reshape(b, nc, Q, N).float()

    dA = dtc * A                                    # (b, nc, Q, H) log-decay
    cum = torch.cumsum(dA, dim=2)                   # within-chunk cumulative
    total = cum[:, :, -1:, :]                       # (b, nc, 1, H)

    # ---- intra-chunk (the dual quadratic form) ----
    # M[i, j] = exp(cum_i - cum_j) for i >= j, masked before the exp
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (b, nc, Q, Q, H)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    Lmat = torch.exp(seg.masked_fill(~causal[:, :, None], float("-inf")))
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)       # (b, nc, Q, Q)
    scores = scores[..., None] * Lmat * dtc[:, :, None, :, :]   # x dt_j
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xc)

    # ---- chunk states ----
    # S_c = sum_j exp(total - cum_j) dt_j B_j (x) x_j : (b, nc, H, N, P)
    decay_to_end = torch.exp(total - cum)                  # (b, nc, Q, H)
    xw = xc * (decay_to_end * dtc)[..., None]              # (b, nc, Q, H, P)
    Sc = torch.einsum("bcjn,bcjhp->bchnp", Bc, xw)
    return ChunkTerms(y_intra, Cc, cum, Sc, torch.exp(total[:, :, 0, :]))


def ssd_chunk_output(x, D, terms, states, decays, first: int = 0):
    """y (b, L, H, P) in x's dtype for the chunks of x (b, L, H, P) whose
    ``terms`` these are, and the final state (b, H, P, N) f32.

    ``states`` (b, n, H, N, P) and ``decays`` (b, n, H) are the chunk
    states and decays of the whole sequence in order, x's own chunks
    those from ``first`` on: ``terms.states`` from 0 in ``ssd_chunked``,
    every shard's concatenated where the sequence is split into shards of
    whole chunks.  The inter-chunk recurrence runs over all n."""
    b, nc, Q, H, P = terms.y_intra.shape
    state = x.new_zeros((b, H, states.shape[-2], P), dtype=torch.float32)
    prev = []
    for c in range(states.shape[1]):    # the state *before* each chunk
        prev.append(state)
        state = state * decays[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev[first:first + nc], dim=1)

    # ---- inter-chunk contribution ----
    decay_from_start = torch.exp(terms.cum)                # (b, nc, Q, H)
    y_inter = torch.einsum("bcin,bchnp->bcihp", terms.C, prev_states) \
        * decay_from_start[..., None]

    y = (terms.y_intra + y_inter).reshape(b, nc * Q, H, P)[:, :x.shape[1]]
    y = (y + x * D[:, None]).float().to(x.dtype)
    return y, state.transpose(-1, -2)                      # (b, H, P, N)


# ----------------------------------------------------------------------
# The mixer: projections, causal conv, SSD, gated norm
# ----------------------------------------------------------------------
def _causal_conv(x, w, b, halo=None):
    """x: (B, L, Cd); w: (k, Cd): the depthwise causal conv as a shifted
    sum in tap order, then silu.  ``halo`` (B, k - 1, Cd): the rows before
    x, where x is a piece of a longer sequence; None: zeros, x its start."""
    k, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0)) if halo is None else \
        torch.cat([halo, x], dim=1)
    out = sum(xp[:, i:i + L, :] * w[i] for i in range(k))
    return F.silu(out + b)


def _split_conv(conv_out, H, P, N):
    """The conv's output split into its x, B and C channels."""
    return (conv_out[..., :H * P], conv_out[..., H * P:H * P + N],
            conv_out[..., H * P + N:])


def _conv_tail(conv_in, k, dtype):
    """The last ``k - 1`` rows of the conv's input (B, L, Cd) in
    ``dtype``, the decode shift register after L steps: left-padded with
    the zeros it starts from when L is short."""
    L = conv_in.shape[1]
    tail = conv_in[:, max(L - (k - 1), 0):, :].to(dtype)
    if L < k - 1:
        tail = F.pad(tail, (0, 0, k - 1 - L, 0))
    return tail


def mamba_mixer(params, x, cfg, chunk: int = 0, return_cache: bool = False,
                cache_dtype=torch.bfloat16):
    """x: (B, L, d_model) -> (B, L, d_model).

    ``return_cache=True`` returns ``(y, cache)``, ``cache`` as
    ``init_mamba_cache`` holds it after L decode steps: the SSD's final
    state and the last ``conv_kernel - 1`` raw conv inputs (left-padded
    with the zeros the decode shift register starts from when L is
    short)."""
    chunk = chunk or cfg.ssd_chunk or 256
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    Bsz, L, _ = x.shape
    with record_function("mamba.in_proj"):
        zxbcdt = dense(params["in_proj"], x)
    z, xs, Bv, Cv, dt = _split_proj(zxbcdt, H, P, N)
    with record_function("mamba.conv"):
        conv_in = torch.cat([xs, Bv, Cv], dim=-1)
        conv_out = _causal_conv(conv_in, params["conv_w"].to(x.dtype),
                                params["conv_b"].to(x.dtype))
    xs, Bv, Cv = _split_conv(conv_out, H, P, N)
    xs = xs.reshape(Bsz, L, H, P)
    with record_function("mamba.ssd"):
        dt = F.softplus(dt.float() + params["dt_bias"].float())
        A = -torch.exp(params["A_log"].float())
        y = ssd_chunked(xs, dt, A, Bv, Cv, params["D"].float(), chunk=chunk,
                        return_final_state=return_cache)
    if return_cache:
        y, final_state = y
        cache = {"ssm": final_state,
                 "conv": _conv_tail(conv_in, params["conv_w"].shape[0],
                                    cache_dtype)}
    with record_function("mamba.gate_norm"):
        # mamba2's norm before the gate, in f32, then x's dtype
        y = y.reshape(Bsz, L, H * P)
        yf = y.float()
        var = yf.square().mean(dim=-1, keepdim=True)
        y = (yf * torch.rsqrt(var + NORM_EPS)
             * params["norm_scale"].float()).to(x.dtype)
        y = y * F.silu(z)
    with record_function("mamba.out_proj"):
        out = dense(params["out_proj"], y)
    if return_cache:
        return out, cache
    return out


# ----------------------------------------------------------------------
# Decode: O(1) a token
# ----------------------------------------------------------------------
def init_mamba_cache(batch: int, cfg, *, stack=(), dtype=torch.bfloat16,
                     device="cpu"):
    """The f32 SSD state (batch, H, P, N) and the conv history (batch,
    k - 1, Cd) in ``dtype``, ``stack`` prepended."""
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = H * P + 2 * N
    return {
        "ssm": torch.zeros((*stack, batch, H, P, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((*stack, batch, cfg.conv_kernel - 1, conv_dim),
                            dtype=dtype, device=device),
    }


def _ssd_decode(ssm, dt, A, xs, Bv, Cv, D):
    """One token of the SSD recurrence in f32: the new state (B, H, P, N)
    from ``ssm`` and y (B, H, P)."""
    dA = torch.exp(dt * A)                                   # (B, H)
    state = ssm * dA[..., None, None] + \
        (dt[:, :, None] * xs)[..., None] * Bv[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", state, Cv) + xs * D[:, None]
    return state, y


def mamba_decode_step(params, x, cache, cfg):
    """x: (B, 1, d_model); cache: {'ssm': (B, H, P, N), 'conv': (B, k-1,
    Cd)}, written in place.  Every row's state advances, a free slot's
    too, as in the reference (``cache_insert`` overwrites it whole).
    Returns (out (B, 1, d_model), cache)."""
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    Bsz = x.shape[0]
    with record_function("mamba.in_proj"):
        zxbcdt = dense(params["in_proj"], x)[:, 0]          # (B, proj)
    z, xs, Bv, Cv, dt = _split_proj(zxbcdt, H, P, N)
    with record_function("mamba.conv"):
        conv_in = torch.cat([xs, Bv, Cv], dim=-1)            # (B, Cd)
        # a new tensor: the history is read from the cache it replaces
        hist = torch.cat([cache["conv"],
                          conv_in[:, None, :].to(cache["conv"].dtype)],
                         dim=1)                              # (B, k, Cd)
        w = params["conv_w"].to(hist.dtype)
        # the taps' dot product, each product exact in f32, rounded once
        acc = (hist.float() * w.float()).sum(dim=1).to(hist.dtype)
        conv_out = F.silu(acc + params["conv_b"].to(hist.dtype))
    xs, Bv, Cv = _split_conv(conv_out, H, P, N)
    xs, Bv, Cv = xs.reshape(Bsz, H, P).float(), Bv.float(), Cv.float()
    with record_function("mamba.ssd"):
        dt = F.softplus(dt.float() + params["dt_bias"].float())
        A = -torch.exp(params["A_log"].float())
        state, y = _ssd_decode(cache["ssm"], dt, A, xs, Bv, Cv,
                               params["D"].float())
    with record_function("mamba.gate_norm"):
        y = y.reshape(Bsz, H * P)
        var = y.square().mean(dim=-1, keepdim=True)
        y = y * torch.rsqrt(var + NORM_EPS) * params["norm_scale"].float()
        y = (y * F.silu(z.float())).to(x.dtype)
    with record_function("mamba.out_proj"):
        out = dense(params["out_proj"], y[:, None, :])
    cache["ssm"].copy_(state)
    cache["conv"].copy_(hist[:, 1:])
    return out, cache
