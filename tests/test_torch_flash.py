"""K10 (flash attention) in the port against the JAX package's
``flash_attention_pallas`` in interpret mode: the port's plain version
``ref.flash_attention_ref`` (what the kernel computes, and the CPU path of
``ops.flash_attention``) and ``ops.flash_attention`` itself, on the same
numpy inputs; plus the CUDA wrapper's contract.  The kernel itself is held
against its plain version on a card in ``test_torch_kernels_cuda.py``.

Tolerances are the reference's own for K10 (``tests/test_kernels.py``):
f32 atol 1e-4, rtol 1e-3 (sums in another order); bf16 atol 8e-2, rtol
2e-2 (one bf16 rounding of the output, scores from bf16 inputs).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402

TOL = {"float32": dict(atol=1e-4, rtol=1e-3),
       "bfloat16": dict(atol=8e-2, rtol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(B, H, KH, Sq, Sk, D, seed=0):
    """(B, H, Sq, D) q and (B, KH, Sk, D) k, v as f32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, D)).astype(np.float32),
            rng.standard_normal((B, KH, Sk, D)).astype(np.float32),
            rng.standard_normal((B, KH, Sk, D)).astype(np.float32))


def _jax(arrs, dtype, **kw):
    out = flash_attention_pallas(*(jnp.asarray(a, JDT[dtype]) for a in arrs),
                                 **kw)
    return np.asarray(out.astype(jnp.float32))


def _port(arrs, dtype, **kw):
    out = ref.flash_attention_ref(*(torch.from_numpy(a).to(TDT[dtype])
                                    for a in arrs), **kw)
    assert out.dtype == TDT[dtype]
    return out.float().numpy()


@pytest.mark.parametrize("k_tile", [32, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KH,D", [
    (1, 64, 4, 4, 16),           # MHA
    (2, 100, 8, 2, 32),          # GQA, ragged seq
    (1, 128, 4, 1, 64),          # MQA
], ids=["mha", "gqa-ragged", "mqa"])
def test_plain_matches_pallas(B, S, H, KH, D, causal, dtype, k_tile):
    arrs = _qkv(B, H, KH, S, S, D, seed=S + H)
    want = _jax(arrs, dtype, causal=causal, q_tile=32, k_tile=k_tile)
    got = _port(arrs, dtype, causal=causal, k_tile=k_tile)
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("window,softcap", [(16, 0.0), (0, 30.0), (8, 50.0)])
def test_window_and_softcap(window, softcap):
    arrs = _qkv(1, 4, 2, 96, 96, 32, seed=7)
    kw = dict(causal=True, window=window, softcap=softcap)
    want = _jax(arrs, "float32", q_tile=32, k_tile=32, **kw)
    got = _port(arrs, "float32", k_tile=32, **kw)
    np.testing.assert_allclose(got, want, **TOL["float32"])


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (50, 77, True, 0), (40, 150, True, 24), (70, 45, False, 16)])
def test_ragged_sk(Sq, Sk, causal, window):
    """Sq != Sk: the causal mask aligns the ends; Sk is not a tile
    multiple."""
    arrs = _qkv(1, 4, 2, Sq, Sk, 32, seed=Sq + Sk)
    kw = dict(causal=causal, window=window, softcap=20.0)
    want = _jax(arrs, "float32", q_tile=32, k_tile=32, **kw)
    got = _port(arrs, "float32", k_tile=32, **kw)
    np.testing.assert_allclose(got, want, **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk", [(300, 200), (260, 130)])
def test_fully_masked_rows_follow_the_kernel(Sq, Sk, dtype):
    """Causal with Sq > Sk: the first Sq - Sk rows have no live key.  K10
    returns sum(v) / (nk * tk) there (its padded keys each get p = 1), the
    port does the same, and ``attention_ref`` (sum(v) / Sk) differs
    unless Sk is a multiple of the key tile."""
    arrs = _qkv(1, 4, 2, Sq, Sk, 16, seed=Sq)
    want = _jax(arrs, dtype, causal=True)           # default tiles, 128
    got = _port(arrs, dtype, causal=True)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    # through the public entry point, BSHD
    bshd = [a.transpose(0, 2, 1, 3) for a in arrs]
    via_ops = ops.flash_attention(*(torch.from_numpy(a).to(TDT[dtype])
                                    for a in bshd), causal=True)
    np.testing.assert_allclose(via_ops.float().numpy().transpose(0, 2, 1, 3),
                               want, **TOL[dtype])
    dead = Sq - Sk
    oracle = np.asarray(jref.attention_ref(
        *(jnp.asarray(a) for a in bshd), causal=True)).transpose(0, 2, 1, 3)
    assert np.abs(oracle[:, :, :dead] - want[:, :, :dead]).max() > 1e-2
    np.testing.assert_allclose(got[:, :, dead:], oracle[:, :, dead:],
                               **TOL[dtype])
    pad = ref.flash_pad_len(Sk)
    v_mean = arrs[2].sum(axis=2, keepdims=True) / pad    # (B, KH, 1, D)
    np.testing.assert_allclose(
        got[:, :, :dead], np.repeat(v_mean, 2, axis=1).repeat(dead, axis=2),
        **TOL[dtype])


@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (False, 0, 0.0), (True, 12, 40.0)])
def test_ops_flash_attention_matches_jax_ops(causal, window, softcap):
    """``ops.flash_attention`` takes BSHD like the models, as the
    reference's does."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="pallas", **kw))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw)
    assert tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL["float32"])


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, 0.0), (True, 10, 30.0), (False, None, 0.0)])
def test_attention_ref_matches_jax(causal, window, softcap):
    """The BSHD oracle is the reference's ``attention_ref``."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 40, 6, 32)).astype(np.float32)
    k = rng.standard_normal((1, 40, 3, 32)).astype(np.float32)
    v = rng.standard_normal((1, 40, 3, 32)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), **kw))
    got = ref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_cpu_path_never_builds(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the CPU path must not build a kernel")
    monkeypatch.setattr(build, "build", boom)
    q, k, v = (torch.from_numpy(a).transpose(1, 2)
               for a in _qkv(1, 2, 1, 8, 8, 16))
    before = flash.flash_attention_cuda.launches
    ops.flash_attention(q, k, v)
    assert flash.flash_attention_cuda.launches == before


class TestCudaWrapperContract:
    """What ``flash_attention_cuda`` and ``ops.flash_attention`` refuse,
    checked before any launch."""

    def _qkv(self, D=16, dtype=torch.float32, device="cpu"):
        return (torch.ones((1, 4, 8, D), dtype=dtype, device=device),
                torch.ones((1, 2, 8, D), dtype=dtype, device=device),
                torch.ones((1, 2, 8, D), dtype=dtype, device=device))

    def test_cpu_tensor_raises(self):
        with pytest.raises(ValueError, match="CUDA"):
            flash.flash_attention_cuda(*self._qkv())

    def test_head_dim_above_256_raises(self):
        with pytest.raises(ValueError, match="256"):
            flash.flash_attention_cuda(*self._qkv(D=264))

    @pytest.mark.parametrize("bad", ["dtype", "mixed", "heads", "window"])
    def test_bad_inputs_raise(self, bad):
        q, k, v = self._qkv()
        kw = {}
        if bad == "dtype":
            q, k, v = q.double(), k.double(), v.double()
        elif bad == "mixed":
            v = v.to(torch.bfloat16)
        elif bad == "heads":
            q = torch.ones((1, 3, 8, 16))
        else:
            kw = dict(window=-1)
        with pytest.raises((TypeError, ValueError)):
            flash.flash_attention_cuda(q, k, v, **kw)

    def test_gradient_on_the_card_is_not_implemented(self):
        """Off the CPU a call that needs a gradient names the missing
        backward (a meta tensor stands in for the card here)."""
        q, k, v = (t.transpose(1, 2) for t in self._qkv(device="meta"))
        with pytest.raises(NotImplementedError, match="backward"):
            ops.flash_attention(q.requires_grad_(), k, v)
        with pytest.raises(ValueError, match="CUDA"):
            ops.flash_attention(q.detach(), k, v)
