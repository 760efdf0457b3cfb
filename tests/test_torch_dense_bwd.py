"""The port's differentiable dense layer (K1 forward, K2/K3 backward)
against ``jax.grad`` of the JAX package's ``ops.dense``, through its jnp
reference and its Pallas kernels in interpret mode.  On the CPU the
autograd ``Function`` runs the kernels' plain versions; the kernels are
held against those on a card in ``test_torch_kernels_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import dense, ops, ref  # noqa: E402

# (rows, Din, Dout, bias, activation)
CASES = {
    "relu-bias": (8, 32, 40, True, "relu"),
    "none-bias": (6, 24, 16, True, "none"),
    "relu-nobias": (4, 16, 24, False, "relu"),
    "ragged": (5, 7, 9, True, "relu"),
    "ragged-none": (3, 65, 33, False, "none"),
}


def _inputs(M, din, dout, bias, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, din)).astype(np.float32)
    w = (rng.standard_normal((din, dout)) / np.sqrt(din)).astype(np.float32)
    b = rng.standard_normal((dout,)).astype(np.float32) if bias else None
    g = rng.standard_normal((M, dout)).astype(np.float32)
    return x, w, b, g


def _jax_grads(x, w, b, g, act, impl):
    """(out, dx, dw, db) of sum(ops.dense(...) * g) in the JAX package."""
    def f(x, w, b):
        return jnp.sum(jops.dense(x, w, b, activation=act, impl=impl) * g)
    args = (jnp.asarray(x), jnp.asarray(w),
            None if b is None else jnp.asarray(b))
    out = jops.dense(*args, activation=act, impl=impl)
    argnums = (0, 1) if b is None else (0, 1, 2)
    grads = jax.grad(f, argnums=argnums)(*args)
    return [np.asarray(a) for a in (out, *grads)]


def _torch_grads(x, w, b, g, act):
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tb = None if b is None else torch.from_numpy(b).requires_grad_()
    out = ops.dense(tx, tw, tb, activation=act)
    leaves = [tx, tw] + ([] if tb is None else [tb])
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    return [out.detach().numpy()] + [t.numpy() for t in grads]


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_dense_grads_match_jax(case, impl):
    M, din, dout, bias, act = CASES[case]
    x, w, b, g = _inputs(M, din, dout, bias)
    want = _jax_grads(x, w, b, g, act, impl)
    got = _torch_grads(x, w, b, g, act)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    for a, e in zip(got[1:], want[1:], strict=True):
        assert a.shape == e.shape and a.dtype == np.float32
        scale = max(float(np.abs(e).max()), 1.0)
        np.testing.assert_allclose(a, e, atol=1e-4 * scale, rtol=1e-4)


def test_leading_dims_flatten_through_the_function():
    x, w, b, g = _inputs(6, 8, 5, True, seed=1)
    tx = torch.from_numpy(x.reshape(2, 3, 8)).requires_grad_()
    out = ops.dense(tx, torch.from_numpy(w), torch.from_numpy(b),
                    activation="relu")
    assert out.shape == (2, 3, 5)
    (dx,) = torch.autograd.grad(out, tx, torch.from_numpy(g.reshape(2, 3, 5)))
    want = _jax_grads(x, w, b, g, "relu", "ref")[1]
    np.testing.assert_allclose(dx.numpy().reshape(6, 8), want, rtol=1e-5,
                               atol=1e-6)


class TestPlainBackward:
    """The plain versions compute what K2 and K3 compute."""

    def test_dx_ref_is_masked_g_times_w_transposed(self):
        x, w, b, g = _inputs(5, 7, 9, True, seed=2)
        out = np.maximum(x @ w + b, 0)
        got = ref.dense_dx_ref(torch.from_numpy(g), torch.from_numpy(w),
                               torch.from_numpy(out)).numpy()
        np.testing.assert_allclose(got, (g * (out > 0)) @ w.T, rtol=1e-5,
                                   atol=1e-6)

    def test_dwdb_ref_sums_rows(self):
        x, w, b, g = _inputs(5, 7, 9, True, seed=3)
        dw, db = ref.dense_dwdb_ref(torch.from_numpy(x), torch.from_numpy(g))
        np.testing.assert_allclose(dw.numpy(), x.T @ g, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(db.numpy(), g.sum(0), rtol=1e-5,
                                   atol=1e-6)


def test_no_grad_calls_skip_the_function(monkeypatch):
    """Serving: with no input requiring grad, ops.dense never enters the
    autograd Function (no autograd cost on the decode path)."""
    def boom(*a, **k):
        raise AssertionError("the Function must not run without grad")
    monkeypatch.setattr(dense.DenseFunction, "apply", boom)
    x, w, b, _ = _inputs(4, 8, 6, True)
    ops.dense(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    with torch.no_grad():
        ops.dense(torch.from_numpy(x), torch.from_numpy(w).requires_grad_())


def test_dx_is_skipped_when_x_needs_no_grad(monkeypatch):
    calls = []
    real = ref.dense_dx_ref
    monkeypatch.setattr(ref, "dense_dx_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x, w, b, g = _inputs(4, 8, 6, True)
    tw = torch.from_numpy(w).requires_grad_()
    out = ops.dense(torch.from_numpy(x), tw, torch.from_numpy(b))
    torch.autograd.grad(out, tw, torch.from_numpy(g))
    assert calls == []


class TestBackwardLauncherContract:
    """What the K2/K3 launchers refuse, checked before any launch."""

    @pytest.mark.parametrize("fn", ["dense_dx_cuda", "dense_dwdb_cuda"])
    def test_cpu_tensor_raises(self, fn):
        with pytest.raises(ValueError, match="CUDA"):
            getattr(dense, fn)(torch.ones((4, 3)), torch.ones((5, 3)))
