"""The port's differentiable conv (K4 forward, K5/K6 backward) against
``jax.grad`` of the JAX package's ``ops.conv2d``, through its jnp
reference and its Pallas kernels in interpret mode, and the plain backward
versions against ``jax.grad`` directly.  The kernels are held against the
plain versions on a card in ``test_torch_kernels_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import conv2d, ops, ref  # noqa: E402

# (B, H, W, Cin, Cout, k, padding, bias, activation)
CASES = {
    "same-k3-relu": (2, 6, 6, 3, 4, 3, "SAME", True, "relu"),
    "same-k2": (3, 5, 6, 3, 4, 2, "SAME", True, "relu"),
    "same-k4-nobias": (1, 7, 6, 2, 3, 4, "SAME", False, "relu"),
    "same-k7": (1, 8, 7, 3, 2, 7, "SAME", True, "none"),
    "valid-k3": (3, 7, 6, 3, 5, 3, "VALID", True, "relu"),
}


def _inputs(B, H, W, cin, cout, k, padding, bias, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout))
         / np.sqrt(k * k * cin)).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32) if bias else None
    Ho, Wo = (H, W) if padding == "SAME" else (H - k + 1, W - k + 1)
    g = rng.standard_normal((B, Ho, Wo, cout)).astype(np.float32)
    return x, w, b, g


def _jax(x, w, b, g, padding, act, impl):
    args = (jnp.asarray(x), jnp.asarray(w),
            None if b is None else jnp.asarray(b))

    def f(x, w, b):
        return jnp.sum(jops.conv2d(x, w, b, padding=padding, activation=act,
                                   impl=impl) * g)
    out = jops.conv2d(*args, padding=padding, activation=act, impl=impl)
    grads = jax.grad(f, argnums=(0, 1) if b is None else (0, 1, 2))(*args)
    return [np.asarray(a) for a in (out, *grads)]


def _torch(x, w, b, g, padding, act):
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tb = None if b is None else torch.from_numpy(b).requires_grad_()
    out = ops.conv2d(tx, tw, tb, padding=padding, activation=act)
    leaves = [tx, tw] + ([] if tb is None else [tb])
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    return [out.detach().numpy()] + [t.numpy() for t in grads]


def _close_grads(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    for a, e in zip(got[1:], want[1:], strict=True):
        assert a.shape == e.shape
        scale = max(float(np.abs(e).max()), 1.0)
        np.testing.assert_allclose(a, e, atol=1e-4 * scale, rtol=1e-4)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_conv_grads_match_jax(case, impl):
    B, H, W, cin, cout, k, padding, bias, act = CASES[case]
    x, w, b, g = _inputs(B, H, W, cin, cout, k, padding, bias)
    _close_grads(_torch(x, w, b, g, padding, act),
                 _jax(x, w, b, g, padding, act, impl))


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_plain_backward_matches_jax_grad(case):
    """conv2d_dx_ref / conv2d_dw_ref (what K5 and K6 compute) against
    jax.grad of the reference's jnp conv, relu mask from the output."""
    B, H, W, cin, cout, k, padding, _, _ = CASES[case]
    x, w, _, g = _inputs(B, H, W, cin, cout, k, padding, False, seed=1)

    def f(x, w):
        return jnp.sum(jax.nn.relu(jref.conv2d_ref(x, w, padding)) * g)
    dx, dw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    out = np.maximum(np.asarray(jref.conv2d_ref(jnp.asarray(x),
                                                jnp.asarray(w), padding)), 0)
    t = torch.from_numpy
    got_dx = ref.conv2d_dx_ref(t(g), t(w), x.shape, padding, t(out))
    got_dw, got_db = ref.conv2d_dw_ref(t(x), t(g), w.shape, padding, t(out))
    for a, e in ((got_dx, dx), (got_dw, dw),
                 (got_db, (g * (out > 0)).sum((0, 1, 2)))):
        e = np.asarray(e)
        scale = max(float(np.abs(e).max()), 1.0)
        np.testing.assert_allclose(a.numpy(), e, atol=1e-4 * scale,
                                   rtol=1e-4)


def test_strided_cpu_call_takes_the_plain_version():
    x, w, b, _ = _inputs(2, 9, 9, 3, 4, 3, "SAME", True)
    for padding in ("SAME", "VALID"):
        got = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), padding=padding, stride=2,
                         activation="relu")
        want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           padding=padding, stride=2, activation="relu",
                           impl="ref")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
def test_strided_card_call_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (a strided conv raises there)")
    x = torch.zeros((1, 8, 8, 3), device="cuda")
    w = torch.zeros((3, 3, 3, 4), device="cuda")
    with pytest.raises(NotImplementedError, match="stride"):
        ops.conv2d(x, w, stride=2)


def test_bad_padding_and_activation_raise():
    x, w, _, _ = _inputs(1, 4, 4, 2, 2, 3, "SAME", False)
    with pytest.raises(ValueError):
        ops.conv2d(torch.from_numpy(x), torch.from_numpy(w), padding="FULL")
    with pytest.raises(ValueError):
        ops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                   activation="gelu")


def test_images_need_no_input_gradient(monkeypatch):
    """Layer 0's input is the images: K5 (its plain version here) is not
    run when x does not require grad."""
    calls = []
    real = ref.conv2d_dx_ref
    monkeypatch.setattr(ref, "conv2d_dx_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x, w, b, g = _inputs(1, 5, 5, 3, 2, 3, "SAME", True)
    tw = torch.from_numpy(w).requires_grad_()
    out = ops.conv2d(torch.from_numpy(x), tw, torch.from_numpy(b),
                     activation="relu")
    torch.autograd.grad(out, tw, torch.from_numpy(g))
    assert calls == []


@pytest.mark.parametrize("B,H,W,Cin,Cout,k,want", [
    (64, 32, 32, 3, 12, 3, 256), (64, 16, 16, 12, 12, 3, 256),
    (64, 8, 8, 12, 12, 3, 256), (64, 4, 4, 12, 12, 3, 64),
    (2, 2, 2, 3, 12, 3, 1)])
def test_dw_splits_fill_the_card_and_depend_on_shapes_only(B, H, W, Cin,
                                                          Cout, k, want):
    """K6 cuts B.H.W into one tile of output pixels a block: 256 tiles (one
    an SM and more) at case7's 32, 16 and 8 px layers, and 16-pixel tiles
    (whole 4 x 4 images) where the layer is too small to fill the card."""
    assert conv2d.dw_splits(B, H, W, Cin, Cout, k, k) == want
