"""Models of the arithmetic of K10's bf16 and f32 instances
(``flash_attention.cu``, ``flash_fwd_bf16_kernel`` and
``flash_fwd_f32_kernel``), held on the CPU at K10's gates against the
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

The f32 instance multiplies on the tensor cores in 3xTF32: each operand x
of QK and PV (q, k, p, v) is split as x_hi = tf32(x), x_lo = tf32(x -
x_hi), rounded as ``cvt.rna`` does, and a b = a_lo b_hi + a_hi b_lo + a_hi
b_hi in f32, over 32-key tiles; its soft-cap divides as x * (1 / cap).  Its gate is the reference's f32 one, atol
1e-4 and rtol 1e-3; one TF32 product (11 bits of each operand) misses it.
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


# ----------------------------------------------------------------- f32
F32_GATE = (1e-4, 1e-3)    # atol, rtol: the reference's f32 tolerance
F32_KEY_TILE = 32          # the f32 kernel's key tile


def tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to nearest, ties
    away from zero, 10 mantissa bits (on the int32 view, add half of the
    dropped 13 bits' range to the magnitude and clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(a, b, split):
    """a @ b on the tensor cores: 3xTF32 (a_lo b_hi + a_hi b_lo + a_hi
    b_hi) where ``split``, else one TF32 product."""
    a_hi, b_hi = tf32(a), tf32(b)
    if not split:
        return torch.matmul(a_hi, b_hi)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)
            + torch.matmul(a_hi, b_hi))


def k10_f32_model(q, k, v, *, causal=True, window=0, softcap=0.0,
                  split=True):
    """What ``flash_fwd_f32_kernel`` computes, in f32 torch: q (B, H, Sq,
    D), k and v (B, KH, Sk, D) f32 -> (B, H, Sq, D).  With ``split`` False,
    both products take one TF32 product of the rounded operands."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    qf = q.reshape(B, KH, H // KH, Sq, D)
    kf, vf = k[:, :, None], v[:, :, None]
    qp = torch.arange(Sq)[:, None] + (Sk - Sq)
    m = torch.full((B, KH, H // KH, Sq, 1), ref.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KH, H // KH, Sq, D))
    for k0 in range(0, Sk, F32_KEY_TILE):
        kt = kf[..., k0:k0 + F32_KEY_TILE, :]
        vt = vf[..., k0:k0 + F32_KEY_TILE, :]
        s = _tf32_product(qf, kt.transpose(-1, -2), split) * (1.0 / D ** 0.5)
        if softcap:   # the kernel divides by the cap as x * (1 / cap)
            s = torch.tanh(s * (1.0 / softcap)) * softcap
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
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _tf32_product(p, vt, split)
        m = m_new
    out = acc / l.clamp_min(1e-20)
    if causal and Sq > Sk:   # rows with no live key: sum(v) / (nk * tk)
        vsum = vf.sum(-2, keepdim=True) / ref.flash_pad_len(Sk)
        dead = (qp < 0)[None, None, None]
        out = torch.where(dead, vsum, out)
    return out.reshape(B, H, Sq, D)


def _f32_peak(got, want):
    """max over elements of |got - want| / (atol + rtol |want|)."""
    atol, rtol = F32_GATE
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


# (B, H, KH, Sq, Sk, D, window, softcap): Gemma-2's head_dim, GQA 2:1 and
# soft-cap 50 with a window and global, a ragged window at D = 64, and
# causal Sq > Sk, whose first rows have no live key
F32_CASES = {
    "gemma2-local": (1, 4, 2, 300, 300, 128, 128, 50.0),
    "gemma2-global": (1, 4, 2, 200, 200, 128, 0, 50.0),
    "ragged-window": (1, 4, 2, 130, 130, 64, 50, 50.0),
    "masked-rows": (1, 4, 2, 300, 200, 64, 0, 0.0),
}


@pytest.fixture(scope="module", params=list(F32_CASES))
def f32_case(request):
    B, H, KH, Sq, Sk, D, window, cap = F32_CASES[request.param]
    rng = np.random.default_rng(Sq + D + 1)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        shape).astype(np.float32)) for shape in (
            (B, H, Sq, D), (B, KH, Sk, D), (B, KH, Sk, D)))
    if cap:
        q = q * QSCALE
    kw = dict(causal=True, window=window, softcap=cap)
    return request.param, (q, k, v), kw


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -12, 3.0])
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                         1.0 + 2.0 ** -10, 1.0, 3.0])
    assert torch.equal(tf32(x), want)


def test_f32_model_keeps_the_gate_against_the_plain_version(f32_case):
    name, (q, k, v), kw = f32_case
    got = k10_f32_model(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    assert got.shape == want.shape and want.dtype == torch.float32
    assert _f32_peak(got, want) <= 1.0, name


def test_f32_model_keeps_the_gate_against_pallas(f32_case):
    name, (q, k, v), kw = f32_case
    got = k10_f32_model(q, k, v, **kw)
    want = flash_attention_pallas(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                  interpret=True, **kw)
    want = torch.from_numpy(np.array(want))
    assert _f32_peak(got, want) <= 1.0, name


def test_one_tf32_product_misses_the_f32_gate():
    """Why the kernel splits every operand: one TF32 product (11 bits of
    q, k, p and v) falls outside the f32 gate that 3xTF32 keeps."""
    B, H, KH, Sq, Sk, D, window, cap = F32_CASES["gemma2-global"]
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        shape).astype(np.float32)) for shape in (
            (B, H, Sq, D), (B, KH, Sk, D), (B, KH, Sk, D)))
    q = q * QSCALE
    kw = dict(causal=True, window=window, softcap=cap)
    want = ref.flash_attention_ref(q, k, v, **kw)
    peak = {split: _f32_peak(k10_f32_model(q, k, v, split=split, **kw),
                             want) for split in (True, False)}
    assert peak[True] <= 1.0 < peak[False], peak
