"""The port's differentiable max pooling (K7 forward, K8 backward) against
the JAX package's ``ops.max_pool2d`` and its ``jax.grad``, through the jnp
reference and the Pallas kernels in interpret mode: remainder rows and
columns, and tied maxima, whose cotangent the reference splits evenly.
The kernels are held against the plain versions on a card in
``test_torch_kernels_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops, pool2d, ref  # noqa: E402


def _inputs(shape, kind, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "ties":           # a relu'd map rounded to a few levels
        x = np.maximum(np.round(x), 0).astype(np.float32)
        x[0, :2, :2, :] = 0.0    # one all-zero window per channel
    B, H, W, C = shape
    g = rng.standard_normal((B, H // 2, W // 2, C)).astype(np.float32)
    return x, g


CASES = {"even": ((2, 8, 8, 3), "normal"), "remainder": ((3, 7, 9, 2),
                                                        "normal"),
         "ties": ((2, 6, 6, 4), "ties"), "ties-odd": ((1, 5, 7, 3), "ties")}


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_pool_and_grad_match_jax(case, impl):
    shape, kind = CASES[case]
    x, g = _inputs(shape, kind)
    jx = jnp.asarray(x)
    want = np.asarray(jops.max_pool2d(jx, impl=impl))
    want_dx = np.asarray(jax.grad(
        lambda a: jnp.sum(jops.max_pool2d(a, impl=impl) * g))(jx))
    tx = torch.from_numpy(x).requires_grad_()
    out = ops.max_pool2d(tx)
    (dx,) = torch.autograd.grad(out, tx, torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), want)
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=1e-6, atol=1e-7)


def test_all_zero_window_splits_the_cotangent_in_four():
    x, g = _inputs((2, 6, 6, 4), "ties")
    tx = torch.from_numpy(x).requires_grad_()
    (dx,) = torch.autograd.grad(ops.max_pool2d(tx), tx, torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy()[0, :2, :2, :],
                               np.broadcast_to(g[0, 0, 0, :] / 4, (2, 2, 4)),
                               rtol=1e-6)


def test_remainder_gets_no_gradient():
    x, g = _inputs((3, 7, 9, 2), "normal")
    dx = ref.max_pool2d_bwd_ref(torch.from_numpy(x),
                                ref.max_pool2d_ref(torch.from_numpy(x)),
                                torch.from_numpy(g)).numpy()
    assert dx.shape == x.shape
    assert not dx[:, 6:, :, :].any() and not dx[:, :, 8:, :].any()
    # every full window passes on exactly its cotangent
    np.testing.assert_allclose(
        dx[:, :6, :8, :].reshape(3, 3, 2, 4, 2, 2).sum((2, 4)), g, rtol=1e-5)


def test_overlapping_pool_raises():
    with pytest.raises(ValueError, match="non-overlapping"):
        ops.max_pool2d(torch.zeros((1, 4, 4, 1)), window=3, stride=2)


def test_launchers_refuse_cpu_tensors():
    x = torch.zeros((1, 4, 4, 1))
    with pytest.raises(ValueError, match="CUDA"):
        pool2d.max_pool2d_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        pool2d.max_pool2d_bwd_cuda(x, torch.zeros((1, 2, 2, 1)),
                                   torch.zeros((1, 2, 2, 1)))


def _k8_writes(plan, B, H, W, C, k):
    """How often K8 writes each dx element: ``pool2d.cu``'s map from a
    thread to (image, output window, lane group), channel groups fastest,
    and from a thread of the remainder range to (image, dropped position,
    lane group), dropped rows first, then the dropped columns of the
    pooled rows."""
    L, Q = plan.lanes, C // plan.lanes
    Ho, Wo, Hk, Wk = H // k, W // k, H // k * k, W // k * k
    hits = np.zeros((B, H, W, C), np.int64)
    for idx in range(plan.blocks * plan.threads):
        if idx < plan.windows:
            q, t = idx % Q, idx // Q
            wo, t = t % Wo, t // Wo
            ho, b = t % Ho, t // Ho
            hits[b, ho * k:(ho + 1) * k, wo * k:(wo + 1) * k,
                 q * L:(q + 1) * L] += 1
        elif idx < plan.windows + plan.remainder:
            r = idx - plan.windows
            q, p = r % Q, r // Q
            per_image = (H - Hk) * W + Hk * (W - Wk)
            b, p = p // per_image, p % per_image
            if p < (H - Hk) * W:
                h, w = Hk + p // W, p % W
            else:
                p -= (H - Hk) * W
                h, w = p // (W - Wk), Wk + p % (W - Wk)
            hits[b, h, w, q * L:(q + 1) * L] += 1
    return hits


@pytest.mark.parametrize("C", [5, 12])
@pytest.mark.parametrize("H,W", [(12, 12), (9, 7), (10, 13)])
@pytest.mark.parametrize("window", [2, 3, 4])
def test_bwd_plan_writes_every_dx_element_once(window, H, W, C):
    """K8's launch geometry: the window threads and the remainder range
    together write every dx element exactly once, with no idle block."""
    B = 2
    plan = pool2d.bwd_plan(B, H, W, C, window)
    assert plan.lanes == (4 if C % 4 == 0 else 1)
    assert pool2d.bwd_plan(B, H, W, C, window, aligned=False).lanes == 1
    total = plan.windows + plan.remainder
    assert plan.threads in (64, 128, 256)
    assert (plan.blocks - 1) * plan.threads < total <= \
        plan.blocks * plan.threads
    assert (_k8_writes(plan, B, H, W, C, window) == 1).all()


def _k7_writes(plan, B, H, W, C, k):
    """How often K7 writes each output element: ``pool2d.cu``'s map from a
    thread to (image, output window, lane group), channel groups fastest,
    each thread writing its ``lanes`` channels."""
    L, Q = plan.lanes, C // plan.lanes
    Ho, Wo = H // k, W // k
    hits = np.zeros((B, Ho, Wo, C), np.int64)
    for idx in range(min(plan.blocks * plan.threads, plan.windows)):
        q, t = idx % Q, idx // Q
        wo, t = t % Wo, t // Wo
        ho, b = t % Ho, t // Ho
        hits[b, ho, wo, q * L:(q + 1) * L] += 1
    return hits


@pytest.mark.parametrize("C", [5, 12])
@pytest.mark.parametrize("H,W", [(12, 12), (9, 7), (10, 13)])
@pytest.mark.parametrize("window", [2, 3, 4])
def test_fwd_plan_writes_every_output_element_once(window, H, W, C):
    """K7's launch geometry: one thread per output window and lane group
    writes every output element exactly once, with no idle block."""
    B = 2
    plan = pool2d.fwd_plan(B, H, W, C, window)
    assert plan.lanes == (4 if C % 4 == 0 else 1)
    assert pool2d.fwd_plan(B, H, W, C, window, aligned=False).lanes == 1
    assert plan.windows == B * (H // window) * (W // window) * C // plan.lanes
    assert plan.threads in (64, 128, 256)
    assert (plan.blocks - 1) * plan.threads < plan.windows <= \
        plan.blocks * plan.threads
    assert (_k7_writes(plan, B, H, W, C, window) == 1).all()
