"""The port's training seam against the JAX package: each optimizer and
``warmup_cosine`` over N steps from equal params and grads, the
synthetic images bit for bit, and the trajectory of ``make_node_round``
against the reference's step body (``jax.value_and_grad`` +
``clip_by_global_norm`` + ``warmup_cosine`` + ``make_optimizer`` +
``apply_updates``, assembled as ``BPTTrainer._make_step_body`` does),
at the tolerances the reference holds its own jnp and Pallas paths to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.types import TrainConfig as JTrainConfig  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.core import bpt_trainer, types  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402


def _tree(rng):
    """A nested dict/list tree of f32 leaves, like CNN params."""
    return {"conv": [{"w": rng.standard_normal((3, 3, 2, 4)),
                      "b": rng.standard_normal((4,))}],
            "fc": [{"w": rng.standard_normal((8, 5)),
                    "b": rng.standard_normal((5,))}]}


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("momentum", {}),
                                     ("momentum", {"beta": 0.5}),
                                     ("adamw", {}),
                                     ("adamw", {"weight_decay": 0.0})])
def test_optimizer_matches_the_reference(name, kw):
    rng = np.random.default_rng(0)
    p0 = _f32(_tree(rng))
    grads = [_f32(_tree(rng)) for _ in range(5)]
    jo, to = jopt.make_optimizer(name, **kw), opt.make_optimizer(name, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = tree_map(torch.from_numpy, p0)
    js, ts = jo.init(jp), to.init(tp)
    for i, g in enumerate(grads):
        lr = 1e-2 / (i + 1)
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, lr)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update(tree_map(torch.from_numpy, g), ts, tp, lr)
        tp = opt.apply_updates(tp, tu)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp),
                    strict=True):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)
    if name == "adamw":
        assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 5


def test_adamw_defaults_match_the_reference():
    import inspect
    want = inspect.signature(jopt.adamw).parameters
    got = inspect.signature(opt.adamw).parameters
    assert {k: v.default for k, v in got.items()} == \
        {k: v.default for k, v in want.items()}


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    g = _f32(_tree(np.random.default_rng(1)))
    jg, jn = jopt.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g),
                                      max_norm)
    tg, tn = opt.clip_by_global_norm(tree_map(torch.from_numpy, g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(jg), tree_leaves(tg),
                    strict=True):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("warmup,total", [(5, 100), (10, 20), (0, 7),
                                          (3, 3)])
def test_warmup_cosine_matches_the_reference(warmup, total):
    """Bit for bit in the warm-up; after it, within one f32 rounding of
    ``cos`` (XLA's and PyTorch's f32 cos differ in the last bit)."""
    js = jopt.warmup_cosine(2e-3, warmup, total)
    ts = opt.warmup_cosine(2e-3, warmup, total)
    for step in range(total + 3):
        if step < warmup:
            assert ts(step) == float(js(step)), step
        else:
            np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6)


def test_bad_optimizer_name_raises():
    with pytest.raises(ValueError):
        opt.make_optimizer("lamb")


def test_image_dataset_is_bit_identical():
    for n, size, seed in ((40, 32, 0), (7, 8, 3)):
        jx, jy = jsynthetic.image_dataset(n, size=size, seed=seed)
        tx, ty = synthetic.image_dataset(n, size=size, seed=seed)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
        assert tx.dtype == jx.dtype and ty.dtype == jy.dtype
    arrays = {"images": tx, "labels": ty}
    for a, b in zip(jsynthetic.batched(arrays, 2, seed=1),
                    synthetic.batched(arrays, 2, seed=1), strict=True):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_train_config_copy_matches_the_reference():
    import dataclasses
    assert [(f.name, f.default) for f in dataclasses.fields(
        types.TrainConfig)] == [(f.name, f.default) for f in
                                dataclasses.fields(JTrainConfig)]
    assert types.OPTIMIZERS == ("sgd", "momentum", "adamw")
    with pytest.raises(ValueError, match="optimizer"):
        types.TrainConfig(optimizer="lamb")
    with pytest.raises(ValueError, match="local_steps"):
        types.TrainConfig(local_steps=0)


# ----------------------------------------------------------------------
# the trajectory of the local step
# ----------------------------------------------------------------------
INNER = dict(name="inner", image_size=8, conv_layers=1, filters=4,
             fc_layers=2, fc_neurons=16)


def _jax_node_round(jcfg, tc):
    """The reference's step body and node round, as BPTTrainer builds
    them (src/repro/core/bpt_trainer.py, _make_step_body and
    _make_node_round)."""
    optimizer = jopt.make_optimizer(tc.optimizer)
    schedule = jopt.warmup_cosine(tc.learning_rate, tc.warmup_steps,
                                  tc.total_steps)

    def loss_fn(p, b):
        return jcnn.cnn_loss(p, b, jcfg), {}

    def step_body(params, opt_state, batch, step):
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, batch)
        if tc.grad_clip:
            grads, _ = jopt.clip_by_global_norm(grads, tc.grad_clip)
        updates, opt_state = optimizer.update(grads, opt_state, params,
                                              schedule(step))
        return jopt.apply_updates(params, updates), opt_state, loss

    def node_round(params, opt_state, batches, step):
        def body(carry, batch):
            p, s = carry
            p, s, loss = step_body(p, s, batch, step)
            return (p, s), loss
        (params, opt_state), losses = jax.lax.scan(body, (params, opt_state),
                                                   batches)
        return params, opt_state, losses[-1]

    return optimizer, node_round


@pytest.mark.parametrize("impl,optimizer,local_steps", [
    ("ref", "adamw", 2), ("pallas", "adamw", 2), ("ref", "momentum", 1),
    ("ref", "sgd", 3)])
def test_node_round_trajectory_matches_the_reference(impl, optimizer,
                                                     local_steps,
                                                     monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_IMPL", impl)
    jcfg, cfg = jcnn.CNNConfig(**INNER), cnn.CNNConfig(**INNER)
    kw = dict(optimizer=optimizer, learning_rate=2e-3, warmup_steps=5,
              total_steps=100, local_steps=local_steps)
    jo, jround = _jax_node_round(jcfg, JTrainConfig(**kw))
    tc = types.TrainConfig(**kw)
    tround = bpt_trainer.make_node_round(
        lambda p, b: (cnn.cnn_loss(p, b, cfg), {}), tc)
    tree = jax.tree_util.tree_map(
        np.asarray, jcnn.init_cnn(jax.random.PRNGKey(0), jcfg))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = weights.params_from_numpy(tree, cfg, "cpu")
    js, ts = jo.init(jp), opt.make_optimizer(optimizer).init(tp)
    B = 16
    xs, ys = synthetic.image_dataset(3 * local_steps * B, size=8, seed=0)
    jl, tl = [], []
    for r in range(3):
        sl = slice(r * local_steps * B, (r + 1) * local_steps * B)
        imgs = xs[sl].reshape(local_steps, B, 8, 8, 3)
        labs = ys[sl].reshape(local_steps, B)
        jp, js, loss = jround(jp, js, {"images": jnp.asarray(imgs),
                                       "labels": jnp.asarray(labs)}, r)
        jl.append(float(loss))
        tp, ts, loss = tround(tp, ts, {"images": torch.from_numpy(imgs),
                                       "labels": torch.from_numpy(labs)}, r)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp),
                    strict=True):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3,
                                   atol=1e-5)


def test_step_body_leaves_its_inputs_alone():
    cfg = cnn.CNNConfig(**INNER)
    params = cnn.init_cnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    before = [t.clone() for t in tree_leaves(params)]
    tc = types.TrainConfig(learning_rate=1e-2, warmup_steps=0)
    state = opt.make_optimizer(tc.optimizer).init(params)
    xs, ys = synthetic.image_dataset(4, size=8, seed=1)
    step = bpt_trainer.make_step_body(
        lambda p, b: (cnn.cnn_loss(p, b, cfg), {}), tc)
    new, _, loss = step(params, state, {"images": torch.from_numpy(xs),
                                        "labels": torch.from_numpy(ys)}, 3)
    assert not loss.requires_grad
    for a, b, c in zip(before, tree_leaves(params), tree_leaves(new),
                       strict=True):
        assert torch.equal(a, b) and not b.requires_grad
        assert not torch.equal(a, c)
