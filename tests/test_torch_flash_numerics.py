"""A model of the arithmetic of K10's bf16 instance (``flash_attention.cu``,
``flash_fwd_bf16_kernel``), held on the CPU at K10's bf16 gate against the
port's plain version ``ref.flash_attention_ref`` and the JAX package's
``flash_attention_pallas`` in interpret mode.

The kernel multiplies on the tensor cores: scores are sums, in f32, of
products of bf16 q and k (exact in f32); the soft-cap, the masks and the
online softmax run in f32 over 64-key tiles; PV is p_hi v + p_lo v with
p_hi = bf16(p) and p_lo = bf16(p - p_hi), about 16 bits of p.  The model
below does the same in plain f32 torch, so the split is shown to keep the
gate before any card runs it.  The kernel itself is held against the
plain version on a card (``chip_smoke.py`` phase 2c and
``test_torch_kernels_cuda.py``).

The gate is ``chip_smoke.py``'s for K10 in bf16: |out - ref| <= 2^-7 |ref|
+ 1e-3 rms(ref), one bf16 ulp of the output plus a little for sums that
cancel.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

GATE = (2.0 ** -7, 1e-3)   # x |ref|, x rms(ref)
KEY_TILE = 64              # the kernel's key tile
QSCALE = 8.0               # q x 8 where a soft-cap is on, so the cap acts


def k10_bf16_model(q, k, v, *, causal=True, window=0, softcap=0.0,
                   split_p=True):
    """What ``flash_fwd_bf16_kernel`` computes, in f32 torch: q (B, H, Sq,
    D), k and v (B, KH, Sk, D) bf16 -> (B, H, Sq, D) f32, before the
    kernel's cast to bf16.  With ``split_p`` False, PV takes p rounded to
    bf16 alone."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, KH, H // KH, Sq, D)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    qp = torch.arange(Sq)[:, None] + (Sk - Sq)
    m = torch.full((B, KH, H // KH, Sq, 1), ref.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KH, H // KH, Sq, D))
    for k0 in range(0, Sk, KEY_TILE):
        kt, vt = kf[..., k0:k0 + KEY_TILE, :], vf[..., k0:k0 + KEY_TILE, :]
        s = torch.matmul(qf, kt.transpose(-1, -2)) * (1.0 / D ** 0.5)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        kp = torch.arange(k0, k0 + kt.shape[-2])[None, :]
        live = kp < Sk
        if causal:
            live = live & (kp <= qp)
        if window:
            live = live & (qp - kp < window)
        s = torch.where(live, s, torch.tensor(ref.NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        p_hi = p.bfloat16().float()
        pv = torch.matmul(p_hi, vt)
        if split_p:
            pv = pv + torch.matmul((p - p_hi).bfloat16().float(), vt)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + pv
        m = m_new
    out = acc / l.clamp_min(1e-20)
    if causal and Sq > Sk:   # rows with no live key: sum(v) / (nk * tk)
        vsum = vf.sum(-2, keepdim=True) / ref.flash_pad_len(Sk)
        dead = (qp < 0)[None, None, None]
        out = torch.where(dead, vsum, out)
    return out.reshape(B, H, Sq, D)


def _peak(got, want):
    """max over elements of |got - want| / (2^-7 |want| + 1e-3 rms(want))."""
    w = want.float()
    allow = GATE[0] * w.abs() + GATE[1] * w.square().mean().sqrt()
    return ((got.float() - w).abs() / allow).max().item()


def _inputs(B, H, KH, Sq, Sk, D, qscale, seed):
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((B, H, Sq, D)).astype(np.float32) * qscale,
            rng.standard_normal((B, KH, Sk, D)).astype(np.float32),
            rng.standard_normal((B, KH, Sk, D)).astype(np.float32))
    return [torch.from_numpy(a).bfloat16() for a in arrs]


# (B, H, KH, Sq, Sk, D, window, softcap): reduced Gemma-2 (head_dim 128,
# GQA 2:1, soft-cap 50, a window of 128 and a global layer), a ragged
# length, and causal Sq > Sk, whose first rows have no live key
CASES = {
    "gemma2-local": (1, 8, 4, 300, 300, 128, 128, 50.0),
    "gemma2-global": (1, 8, 4, 300, 300, 128, 0, 50.0),
    "ragged-window": (1, 4, 2, 333, 333, 64, 100, 50.0),
    "masked-rows": (1, 4, 2, 300, 200, 64, 0, 0.0),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    B, H, KH, Sq, Sk, D, window, cap = CASES[request.param]
    q, k, v = _inputs(B, H, KH, Sq, Sk, D, QSCALE if cap else 1.0,
                      seed=Sq + D)
    kw = dict(causal=True, window=window, softcap=cap)
    return request.param, (q, k, v), kw


def test_model_keeps_the_gate_against_the_plain_version(case):
    name, (q, k, v), kw = case
    got = k10_bf16_model(q, k, v, **kw).bfloat16()
    want = ref.flash_attention_ref(q, k, v, **kw)
    assert got.shape == want.shape and want.dtype == torch.bfloat16
    assert _peak(got, want) <= 1.0, name


def test_model_keeps_the_gate_against_pallas(case):
    name, (q, k, v), kw = case
    got = k10_bf16_model(q, k, v, **kw).bfloat16()
    want = flash_attention_pallas(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
        interpret=True, **kw)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert _peak(got, want) <= 1.0, name


def test_p_in_bf16_alone_misses_the_gate(case):
    """Why the kernel splits p: PV with p rounded to bf16 alone (8 bits)
    falls outside the gate that the split (about 16 bits) keeps."""
    name, (q, k, v), kw = case
    want = ref.flash_attention_ref(q, k, v, **kw)
    peak = {split: _peak(k10_bf16_model(q, k, v, split_p=split, **kw
                                        ).bfloat16(), want)
            for split in (True, False)}
    assert peak[True] <= 1.0 < peak[False], (name, peak)
