"""``block_skip`` in the port's ``chunked_attention``: the kv blocks wholly
outside the causal or window band of a q chunk are skipped on the host,
and the result equals the unskipped path bit for bit (causal, windowed,
Gemma-2's soft-capped windows, ragged chunks; f32 and bf16) and the
reference's ``chunked_attention(block_skip=True)`` at the port's
tolerances (``tests/test_torch_lm.py``'s: bf16 atol 8e-2 / rtol 2e-2; f32
atol 1e-5 / rtol 1e-4).  The skip counter equals counts worked out by
hand, and a whole prefill under the ``opt`` variant equals the plain
config's bit for bit.  One torch thread (``tests/torch_threads.py``): in
the six-worker suite the module took 65 s on every core, 5 s alone.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

TOL = {"float32": dict(atol=1e-5, rtol=1e-4),
       "bfloat16": dict(atol=8e-2, rtol=2e-2)}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# (causal, window, softcap, S, q_chunk, k_chunk, skipped): S = 40 in q
# chunks of 8 (rows 0-7, 8-15, ..., 32-39) and k blocks of 16 (keys 0-15,
# 16-31, 32-39, the last ragged), or S = 37 (the last q chunk rows 32-36).
#  causal: a block is dead past the chunk's last row: chunk 0 drops
#    blocks 1 and 2, chunk 1 blocks 1 and 2, chunks 2 and 3 block 2 -> 6;
#  window 8: also dead when its last key <= first row - 8: chunk 3 (first
#    row 24) drops block 0 (last key 15 <= 16), chunk 4 (32) drops block 0
#    (15 <= 24) -> 6 + 2 = 8;
#  window 8 without causal: only the window rule -> 2;
#  S = 37, causal, window 20, q chunk 8, k blocks of 8 (0-7, ..., 32-36):
#    causal drops 4 + 3 + 2 + 1 = 10; the window drops block 0 for chunk 4
#    (first row 32: 7 <= 12) -> 11.
CASES = [
    ("causal", True, None, 0.0, 40, 8, 16, 6),
    ("window", True, 8, 0.0, 40, 8, 16, 8),
    ("window_bidir", False, 8, 0.0, 40, 8, 16, 2),
    ("gemma2", True, 20, 50.0, 37, 8, 8, 11),
]


def _qkv(S, seed=0, H=4, KH=2, D=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, S, H, D)).astype(np.float32),
            rng.standard_normal((2, S, KH, D)).astype(np.float32),
            rng.standard_normal((2, S, KH, D)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,causal,window,cap,S,qc,kc,skipped", CASES,
                         ids=[c[0] for c in CASES])
def test_block_skip_is_bit_exact(name, causal, window, cap, S, qc, kc,
                                 skipped, dtype):
    tdt = DT[dtype][1]
    q, k, v = (torch.from_numpy(a).to(tdt) for a in _qkv(S))
    kw = dict(causal=causal, window=window, attn_softcap=cap, q_chunk=qc,
              k_chunk=kc)
    plain = attention.chunked_attention(q, k, v, **kw)
    attention.reset_block_skips()
    fast = attention.chunked_attention(q, k, v, block_skip=True, **kw)
    assert attention.BLOCK_SKIPS["skipped"] == skipped
    assert fast.dtype == plain.dtype
    assert torch.equal(fast, plain)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,causal,window,cap,S,qc,kc,skipped", CASES,
                         ids=[c[0] for c in CASES])
def test_block_skip_matches_reference(name, causal, window, cap, S, qc, kc,
                                      skipped, dtype):
    jdt, tdt = DT[dtype]
    arrs = _qkv(S, seed=1)
    kw = dict(causal=causal, window=window, attn_softcap=cap, q_chunk=qc,
              k_chunk=kc, block_skip=True)
    want = jattn.chunked_attention(*(jnp.asarray(a, jdt) for a in arrs),
                                   **kw)
    got = attention.chunked_attention(*(torch.from_numpy(a).to(tdt)
                                        for a in arrs), **kw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def test_no_skip_without_the_flag():
    q, k, v = (torch.from_numpy(a) for a in _qkv(40))
    attention.reset_block_skips()
    attention.chunked_attention(q, k, v, causal=True, window=8, q_chunk=8,
                                k_chunk=16)
    assert attention.BLOCK_SKIPS["skipped"] == 0


def test_live_block_bounds():
    lb = attention.live_block
    assert lb(0, 7, 8, 15, causal=True, window=None) is False
    assert lb(0, 7, 7, 15, causal=True, window=None) is True
    assert lb(24, 31, 0, 15, causal=True, window=8) is False    # 15 <= 16
    assert lb(24, 31, 0, 16, causal=True, window=8) is False    # 16 <= 16
    assert lb(24, 31, 0, 17, causal=True, window=8) is True     # 17 > 16
    assert lb(0, 7, 32, 39, causal=False, window=0) is True


@pytest.mark.parametrize("arch", ["gemma2-27b", "hymba-1.5b"])
def test_opt_variant_prefill_is_bit_exact(arch):
    """A reduced windowed arch at attention chunks of 8 over a 48-token
    prompt (past its window): the ``opt`` variant's prefill logits and
    every cache leaf equal the plain config's, and blocks were skipped."""
    base = dataclasses.replace(configs.get_reduced(arch), attn_q_chunk=8,
                               attn_k_chunk=8)
    opt = dataclasses.replace(base, attn_kv_gather=True,
                              attn_block_skip=base.sliding_window > 0)
    assert opt.attn_block_skip
    params = lm.init_params(base, torch.Generator("cpu").manual_seed(0),
                            "cpu")
    tokens = torch.randint(0, base.vocab_size, (2, 48),
                           generator=torch.Generator().manual_seed(1))
    plain_logits, plain_cache = lm.prefill(params, tokens, base)
    attention.reset_block_skips()
    logits, cache = lm.prefill(params, tokens, opt)
    assert attention.BLOCK_SKIPS["skipped"] > 0
    assert torch.equal(logits, plain_logits)
    flat = [(k, v) for k, v in _leaves(cache.layers)]
    plain = dict(_leaves(plain_cache.layers))
    for key, leaf in flat:
        assert torch.equal(leaf, plain[key]), key


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree
