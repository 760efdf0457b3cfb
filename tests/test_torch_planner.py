"""The port's ``core/planner.py`` against the reference's.

* ``plan_for_axes`` equals the reference's plan field by field (specs as
  tuples) for Table-2 cases 1-7 and the equivalence config, for (nodes,
  model) in {(2,2), (4,2), (2,4)}, families "", batch and channel, at B
  32 and 30, given the reference's ``HW`` (a TPU v5e's figures); the
  infeasible cases raise alike.  The port's default ``HW`` (the H100's
  data-sheet rates) gives a feasible plan of its own.
* ``plan_scope`` / ``take`` walk the layers in the reference's order.
* ``grad_combine`` recombines K = 2 shards into the unsharded gradient
  (masked and not), held to ``jax.value_and_grad`` of the reference's own
  test function at its rtol 1e-6; the channel collectives give the
  column-parallel fc the port's unsharded w and b gradients bit for bit,
  and the reference's loss and gradients within rtol 1e-5.
* ``ops.dense`` under a channel LayerPlan equals the plain call.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import planner as jplanner  # noqa: E402
from repro.launch.roofline import HW as JHW  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.bpt_trainer import value_and_grad  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.launch.roofline import HW  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

CPU = torch.device("cpu")
TPU_HW = HW(**dataclasses.asdict(JHW()))
EQUIV = dict(name="equiv", image_size=8, conv_layers=1, filters=4,
             fc_layers=1, fc_neurons=32)
PLAN = dict(name="plan", image_size=8, conv_layers=1, filters=4,
            fc_layers=2, fc_neurons=32)
CASES = [f"case{i}" for i in range(1, 8)] + ["equiv", "plan"]


def _cfgs(case):
    if case == "equiv":
        return cnn.CNNConfig(**EQUIV), jcnn.CNNConfig(**EQUIV)
    if case == "plan":
        return cnn.CNNConfig(**PLAN), jcnn.CNNConfig(**PLAN)
    return cnn.make_case(case), jcnn.make_case(case)


def _fields(plan):
    """A plan as plain values: specs as tuples, layers as dicts."""
    out = {}
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if f.name == "layers":
            v = tuple(_fields(lp) for lp in v)
        elif f.name.endswith("spec"):
            v = tuple(v)
        out[f.name] = v
    return out


def _plan_or_error(fn, cfg, **kw):
    try:
        return _fields(fn(cfg, **kw))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("axes", [(2, 2), (4, 2), (2, 4)])
@pytest.mark.parametrize("family", ["", "batch", "channel"])
@pytest.mark.parametrize("batch_size", [32, 30])
def test_plan_for_axes_equals_the_reference(case, axes, family, batch_size):
    cfg, jcfg = _cfgs(case)
    kw = dict(nodes=axes[0], model=axes[1], batch_size=batch_size,
              family=family)
    got = _plan_or_error(planner.plan_for_axes, cfg, hw=TPU_HW, **kw)
    want = _plan_or_error(jplanner.plan_for_axes, jcfg, **kw)
    assert got == want


@pytest.mark.parametrize("model,batch_size,family", [
    (1, 32, ""), (2, 32, ""), (4, 30, ""), (2, 32, "channel"),
    (2, 32, "batch")])
def test_generic_plan_equals_the_reference(model, batch_size, family):
    kw = dict(nodes=4, model=model, batch_size=batch_size, family=family)
    got = _plan_or_error(planner.plan_for_axes, None, **kw)
    want = _plan_or_error(jplanner.plan_for_axes, None, **kw)
    assert got == want


@pytest.mark.parametrize("case", CASES)
def test_param_bytes_equal_the_reference(case):
    cfg, jcfg = _cfgs(case)
    assert planner.network_param_bytes(cfg) == \
        jplanner.network_param_bytes(jcfg)


@pytest.mark.parametrize("case", ["case1", "case7", "equiv"])
def test_the_h100_default_plans_a_feasible_family(case):
    cfg, _ = _cfgs(case)
    assert HW() == HW(67e12, 3.35e12, 450e9)
    for model in (2, 4):
        plan = planner.plan_for_axes(cfg, nodes=2, model=model,
                                     batch_size=32)
        assert plan.family in ("batch", "channel")
        assert plan.total_cost_s > 0
        assert plan.total_cost_s == pytest.approx(
            sum(lp.cost_s for lp in plan.layers))
        assert {lp.shards for lp in plan.layers} == {model}


def test_plan_network_reads_the_mesh_axes():
    cfg, _ = _cfgs("plan")
    plan = planner.plan_network(cfg, pmesh.make_hybrid_mesh(
        2, 2, devices=[CPU] * 4), batch_size=32)
    assert (plan.nodes, plan.model) == (2, 2)
    plan = planner.plan_network(cfg, pmesh.make_nodes_mesh(
        2, devices=[CPU] * 2), batch_size=32)
    assert plan.model == 1 and plan.family == "replicate"


def test_take_walks_layers_in_kind_order():
    """``take`` hands out the reference's LayerPlans in the reference's
    order, wrapping per kind; the port's ``executed`` keeps the first
    traversal (the reference's, taken at trace time, holds every take of
    its one trace)."""
    cfg, jcfg = _cfgs("plan")
    runs = []
    for mod, c in ((planner, cfg), (jplanner, jcfg)):
        plan = mod.plan_for_axes(c, nodes=2, model=2, batch_size=32,
                                 family="batch")
        with mod.plan_scope(plan) as sc:
            got = [mod.take(k) for k in ("conv", "fc", "fc", "fc")]
            assert mod.take("missing") is None
            assert mod.current_plan() is plan
        runs.append(([lp.name for lp in got],
                     [lp.name for lp in sc.executed]))
    assert runs[0][0] == runs[1][0] == ["conv0", "fc0", "fc1", "fc0"]
    assert runs[1][1] == ["conv0", "fc0", "fc1", "fc0"]
    assert runs[0][1] == ["conv0", "fc0", "fc1"]
    assert planner.take("conv") is None and planner.current_plan() is None
    assert planner.current_devices() == ()


def test_scope_records_the_first_traversal():
    cfg, _ = _cfgs("plan")
    plan = planner.plan_for_axes(cfg, nodes=2, model=2, batch_size=32)
    with planner.plan_scope(plan, [CPU] * 2) as sc:
        for _ in range(3):
            for kind in ("conv", "fc", "fc"):
                planner.take(kind)
        assert planner.current_devices() == (CPU, CPU)
    assert sc.executed == [lp for lp in plan.layers if lp.kind != "pool"]


# ----------------------------------------------------------------------
# the batch family's recombination, against the unsharded gradient
# ----------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_grad_combine_is_exact(masked):
    """``tests/test_planner.py::TestGradCombine``'s loss over 8 rows split
    into 2 shards, against jax.value_and_grad of the unsharded loss."""
    w = np.linspace(0.1, 0.5, 5, dtype=np.float32)
    x = (np.arange(8.0).reshape(8, 1) * np.ones((8, 5))).astype(np.float32)
    mask = np.array([1, 1, 1, 0, 1, 1, 0, 0] if masked else [1] * 8,
                    np.float32)

    def jloss(w, batch):
        per = jnp.sum(batch["x"] * w, axis=-1) ** 2
        m = batch["mask"]
        return jnp.sum(per * m) / jnp.maximum(jnp.sum(m), 1.0)

    want_loss, want_grad = jax.value_and_grad(jloss)(
        jnp.asarray(w), {"x": jnp.asarray(x), "mask": jnp.asarray(mask)})

    def loss(p, batch):
        per = (batch["x"] * p["w"]).sum(-1) ** 2
        m = batch["mask"]
        return (per * m).sum() / torch.clamp(m.sum(), min=1.0), {}

    plan = planner.plan_for_axes(None, nodes=1, model=2, batch_size=8)
    combine = planner.grad_combine(plan)
    params = {"w": torch.from_numpy(w)}
    losses, grads, shards = [], [], []
    for k in range(2):
        shard = {"x": torch.from_numpy(x[4 * k:4 * k + 4]),
                 "mask": torch.from_numpy(mask[4 * k:4 * k + 4])}
        (lk, _), gk = value_and_grad(loss, params, shard)
        losses.append(lk)
        grads.append(gk)
        shards.append(shard if masked else {"x": shard["x"]})
    got_loss, got = combine(losses, grads, shards, CPU)
    np.testing.assert_allclose(got_loss.numpy(), want_loss, rtol=1e-6)
    np.testing.assert_allclose(got["w"].numpy(), want_grad, rtol=1e-6)


def _fc_data():
    k = jax.random.PRNGKey(0)
    x = jax.random.normal(k, (4, 6))
    w = jax.random.normal(jax.random.fold_in(k, 1), (6, 8))
    b = jax.random.normal(jax.random.fold_in(k, 2), (8,))
    return x, w, b


def _fc_want():
    x, w, b = _fc_data()

    def ref_loss(x, w, b):
        return jnp.sum((x @ w + b) ** 2)

    return jax.value_and_grad(ref_loss, argnums=(0, 1, 2))(x, w, b)


def _fc_grads(sharded):
    """Loss and (x, w, b) gradients of ``sum((x @ w + b) ** 2)``, unsharded
    or through the three collectives around two column shards."""
    x, w, b = (torch.from_numpy(np.array(a)).requires_grad_()
               for a in _fc_data())
    if sharded:
        devices = [CPU, CPU]
        xs = planner.rep_in(x, devices)
        ws = planner.shard_dim(w, devices)
        bs = planner.shard_dim(b, devices)
        assert all(s.is_contiguous() and s.shape == (6, 4) for s in ws)
        y = planner.gather_cols([xk @ wk + bk for xk, wk, bk in
                                 zip(xs, ws, bs)], CPU)
    else:
        y = x @ w + b
    loss = (y ** 2).sum()
    loss.backward()
    return loss.detach(), (x.grad, w.grad, b.grad)


def test_column_parallel_fc_grads_exact():
    """``tests/test_planner.py::TestChannelCollectives``: the column-
    parallel fc's w and b gradients are the unsharded layer's bit for bit
    (each column block's product is the same product), and x's gradient
    is the two shards' partial products added (``rep_in``'s backward), a
    sum in another order (within rtol 1e-5 of the unsharded one).  All
    are held to jax.value_and_grad of the reference's unsharded loss at
    rtol 1e-5 / atol 1e-5 (the loss at rtol 1e-6): two libraries' f32
    products of 4-row sums differ by a few units in the last place."""
    want_loss, want = _fc_want()
    loss, got = _fc_grads(sharded=True)
    _, plain = _fc_grads(sharded=False)
    assert torch.equal(got[1], plain[1]) and torch.equal(got[2], plain[2])
    np.testing.assert_allclose(got[0].numpy(), plain[0].numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-6)
    for g, wg in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("activation", ["none", "relu"])
def test_ops_dense_under_a_channel_plan(activation):
    """``ops.dense`` under a channel LayerPlan: the same output and
    gradients as the plain call, and the plan recorded as taken."""
    x, w, b = (torch.from_numpy(np.array(a)) for a in _fc_data())
    lp = planner.LayerPlan(name="fc0", kind="fc", parallel_dim="channel",
                           spec=(None, "model"), tile=4, shards=2)
    plan = planner.NetworkPlan(nodes=1, model=2, family="channel",
                               layers=(lp,), batch_spec=("nodes",),
                               param_spec=("nodes",), combine_grads=False,
                               total_cost_s=0.0)
    outs = []
    for scoped in (False, True):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        if scoped:
            with planner.plan_scope(plan, [CPU, CPU]) as sc:
                y = ops.dense(*leaves, activation=activation)
            assert sc.executed == [lp]
        else:
            y = ops.dense(*leaves, activation=activation)
        (y ** 2).sum().backward()
        outs.append([y.detach()] + [t.grad for t in leaves])
    for a, c in zip(*outs, strict=True):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-6,
                                   atol=1e-6)
    with planner.plan_scope(plan, [CPU]):
        with pytest.raises(ValueError, match="2-way channel plan on 1"):
            ops.dense(x, w, b)
