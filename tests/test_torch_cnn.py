"""The port's Table-2 CNN against the JAX package's ``repro.models.cnn``:
layer shapes for every case, the forward, the Eq. 16 loss (with and
without a mask) and the full gradient from one numpy parameter set, the
weights round trip, and the port's own He init by its statistics."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.core.bpt_trainer import value_and_grad  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.data.synthetic import image_dataset  # noqa: E402
from repro_torch.models import cnn  # noqa: E402


def _numpy_params(jcfg, seed):
    return jax.tree_util.tree_map(
        np.asarray, jcnn.init_cnn(jax.random.PRNGKey(seed), jcfg))


@pytest.mark.parametrize("case", cnn.TABLE2_CASES)
def test_shapes_match_the_reference(case):
    assert cnn.TABLE2_CASES == jcnn.TABLE2_CASES
    cfg, jcfg = cnn.make_case(case), jcnn.make_case(case)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cnn._conv_shapes(cfg) == jcnn._conv_shapes(jcfg)
    want = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)),
        jax.eval_shape(lambda: jcnn.init_cnn(jax.random.PRNGKey(0), jcfg)))
    got = cnn.init_cnn(cfg, None, device="meta")
    assert [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in tree_leaves(got)] == jax.tree_util.tree_leaves(
        want, is_leaf=lambda x: isinstance(x, tuple))


def test_make_case_arguments_match_the_reference():
    for case in cnn.TABLE2_CASES:
        assert dataclasses.asdict(cnn.make_case(case, 16, 7, 1)) == \
            dataclasses.asdict(jcnn.make_case(case, 16, 7, 1))


def test_case7_parameter_count():
    params = cnn.init_cnn(cnn.make_case("case7"), None, device="meta")
    assert sum(t.numel() for t in tree_leaves(params)) == 20_428_118


def _batch(n, size, seed, mask=False):
    xs, ys = image_dataset(n, size=size, seed=seed)
    jb = {"images": jnp.asarray(xs), "labels": jnp.asarray(ys)}
    tb = {"images": torch.from_numpy(xs), "labels": torch.from_numpy(ys)}
    if mask:
        m = np.array([1.0, 0.0] * (n // 2), np.float32)
        jb["mask"], tb["mask"] = jnp.asarray(m), torch.from_numpy(m)
    return jb, tb


@pytest.mark.parametrize("mask", [False, True], ids=["mean", "masked"])
@pytest.mark.parametrize("case", ["case1", "case2"])
def test_loss_and_grads_match_the_reference(case, mask, monkeypatch):
    """Table-2 case1/case2 at 32 px, B = 2: the loss at rtol 1e-5 and every
    gradient at 1e-4 x scale, the reference's gate between its jnp and
    Pallas paths (tests/test_inner_pallas.py)."""
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "ref")
    jcfg, cfg = jcnn.make_case(case), cnn.make_case(case)
    tree = _numpy_params(jcfg, 5)
    jb, tb = _batch(2, 32, 6, mask)
    loss_r, grads_r = jax.value_and_grad(
        lambda p: jcnn.cnn_loss(p, jb, jcfg))(jax.tree_util.tree_map(
            jnp.asarray, tree))
    params = weights.params_from_numpy(tree, cfg, "cpu")
    np.testing.assert_allclose(
        cnn.cnn_forward(params, tb["images"], cfg).detach().numpy(),
        np.asarray(jcnn.cnn_forward(jax.tree_util.tree_map(jnp.asarray, tree),
                                    jb["images"], jcfg)),
        rtol=1e-5, atol=1e-5)
    (loss, _), grads = value_and_grad(
        lambda p, b: (cnn.cnn_loss(p, b, cfg), {}), params, tb)
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=1e-5)
    for g, e in zip(tree_leaves(grads), jax.tree_util.tree_leaves(grads_r),
                    strict=True):
        e = np.asarray(e)
        scale = max(float(np.abs(e).max()), 1.0)
        np.testing.assert_allclose(g.numpy(), e, atol=1e-4 * scale,
                                   rtol=1e-4)


def test_accuracy_matches_the_reference(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "ref")
    jcfg, cfg = jcnn.make_case("case1"), cnn.make_case("case1")
    tree = _numpy_params(jcfg, 1)
    jb, tb = _batch(8, 32, 2)
    want = jcnn.cnn_accuracy(jax.tree_util.tree_map(jnp.asarray, tree), jb,
                             jcfg)
    got = cnn.cnn_accuracy(weights.params_from_numpy(tree, cfg, "cpu"), tb,
                           cfg)
    assert float(got) == float(want)


class TestWeights:
    def test_round_trip_of_a_cnn_tree(self):
        jcfg, cfg = jcnn.make_case("case2"), cnn.make_case("case2")
        tree = _numpy_params(jcfg, 3)
        params = weights.params_from_numpy(tree, cfg, "cpu")
        assert isinstance(params["conv"], list) and len(params["conv"]) == 4
        back = weights.params_to_numpy(params)
        for a, b in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(back), strict=True):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("fault", ["shape", "length", "key"])
    def test_mismatch_raises(self, fault):
        jcfg, cfg = jcnn.make_case("case1"), cnn.make_case("case1")
        tree = _numpy_params(jcfg, 0)
        if fault == "shape":
            tree["fc"][0]["w"] = tree["fc"][0]["w"][:-1]
        elif fault == "length":
            tree["conv"] = tree["conv"][:1]
        else:
            del tree["fc"][1]["b"]
        with pytest.raises(ValueError, match="params"):
            weights.params_from_numpy(tree, cfg, "cpu")


def test_init_statistics():
    """He init: std sqrt(2 / fan_in) for every weight, zero biases."""
    cfg = cnn.make_case("case3")
    params = cnn.init_cnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    for layer in params["conv"] + params["fc"]:
        w, b = layer["w"], layer["b"]
        assert w.dtype == torch.float32 and not b.any()
        fan = int(np.prod(w.shape[:-1]))
        std = float(w.std())
        assert abs(std / np.sqrt(2.0 / fan) - 1) < 0.1 + 3 / np.sqrt(
            w.numel()), (tuple(w.shape), std)
        assert abs(float(w.mean())) < 4 * np.sqrt(2.0 / fan / w.numel())


def test_init_needs_an_explicit_generator():
    cfg = cnn.make_case("case1")
    with pytest.raises(TypeError, match="Generator"):
        cnn.init_cnn(cfg, None, device="cpu")
