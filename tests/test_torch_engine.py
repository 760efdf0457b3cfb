"""The port's engine layer against the reference's: the ``resolve_engine``
matrix of ``tests/test_engine.py`` (backend, strategy, requested,
fallback text, error text) on one device, ``engine_config``, the engine
registry, the event counts and default eval cadences of the streaming
API, and the multi-device engines' and the planner's arguments, which
resolve as the reference's do.  The checkpoint and resume hooks are held
in ``tests/test_torch_chaos.py``, the multi-device engines' trajectories
in ``tests/test_torch_device_outer.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.engine as jengine  # noqa: E402
from repro.core.bpt_trainer import BPTTrainer as JTrainer  # noqa: E402
from repro.core.types import TrainConfig as JTrainConfig  # noqa: E402
from repro.data.pipeline import IDPADataset as JDataset  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.bpt_trainer import BPTTrainer, TrainHooks  # noqa: E402
from repro_torch.core.faults import FaultSchedule  # noqa: E402
from repro_torch.core.types import TrainConfig  # noqa: E402
from repro_torch.data.pipeline import IDPADataset  # noqa: E402
from repro_torch.data.synthetic import image_dataset  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

ONE_CPU = [torch.device("cpu")]

MATRIX = [(s, f, d, u)
          for s in ("sgwu", "agwu", "sync")
          for f in (True, False)
          for d in (True, False)
          for u in (True, False)]


def _outcome(resolve, cfg, devices):
    """What a resolve_engine call gives: (backend, strategy, requested,
    fallback) or the exception's type and text."""
    try:
        p = resolve(cfg, devices)
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return p.backend, p.strategy, p.requested, p.fallback


@pytest.mark.parametrize("strategy,fused,device,uneven", MATRIX)
@pytest.mark.parametrize("m", [2, 8])
def test_resolve_matrix_matches_the_reference(strategy, fused, device,
                                              uneven, m):
    kw = dict(outer_strategy=strategy, fused_outer=fused,
              device_outer=device, uneven_batches=uneven, outer_nodes=m)
    got = _outcome(engine.resolve_engine, TrainConfig(**kw), ONE_CPU)
    want = _outcome(jengine.resolve_engine, JTrainConfig(**kw),
                    jax.devices()[:1])
    assert got == want
    if got[0] in engine.ENGINES:
        plan = engine.resolve_engine(TrainConfig(**kw), ONE_CPU)
        assert plan.engine_cls is engine.ENGINES[plan.backend]
        assert plan.engine_cls.backend == plan.backend
        assert plan.engine_cls.strategy == plan.strategy


def test_resolve_engine_defaults_to_the_visible_devices():
    """Here no card is visible: one CPU device, the reference's 'have 1'."""
    cfg = TrainConfig(outer_strategy="sgwu", device_outer=True,
                      outer_nodes=4)
    want = jengine.resolve_engine(JTrainConfig(
        outer_strategy="sgwu", device_outer=True, outer_nodes=4),
        devices=jax.devices()[:1])
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default counts CUDA devices")
    assert engine.resolve_engine(cfg).fallback == want.fallback


@pytest.mark.parametrize("strategy", ["sgwu", "agwu"])
def test_enough_devices_for_the_device_engines_is_not_ported(strategy):
    """m = 1 fits any backend: the port runs its device engines there, as
    the reference does (once not ported, now resolved alike); a named mesh
    resolves on a pool large enough for it."""
    cfg = TrainConfig(outer_strategy=strategy, device_outer=True,
                      outer_nodes=1)
    want = jengine.resolve_engine(JTrainConfig(
        outer_strategy=strategy, device_outer=True, outer_nodes=1),
        jax.devices()[:1])
    plan = engine.resolve_engine(cfg, ONE_CPU)
    assert (plan.backend, plan.requested, plan.fallback) == \
        (want.backend, want.requested, want.fallback)
    assert plan.engine_cls is engine.ENGINES[want.backend]
    plan = engine.resolve_engine(TrainConfig(
        outer_strategy="sgwu", device_outer=True, mesh_name="nodes2",
        outer_nodes=2), ONE_CPU * 2)
    assert plan.backend == "device" and plan.mesh.shape == {"nodes": 2}


@pytest.mark.parametrize("name", ["scan", "sequential", "vmap", "device",
                                  "heap", "heap-device"])
def test_engine_config_roundtrip(name):
    got = engine.engine_config(name, outer_nodes=2)
    assert got == jengine.engine_config(name, outer_nodes=2)
    plan = engine.resolve_engine(TrainConfig(**got), ONE_CPU)
    jplan = jengine.resolve_engine(JTrainConfig(**got), jax.devices()[:1])
    assert plan.requested == name == jplan.requested
    assert (plan.backend, plan.fallback) == (jplan.backend, jplan.fallback)
    if name not in ("device", "heap-device"):
        assert plan.backend == name and not plan.fallback
    else:                   # 2 nodes on one device: the recorded fallback
        assert plan.fallback
        assert engine.resolve_engine(TrainConfig(**got),
                                     ONE_CPU * 2).backend == name


def test_engine_config_unknown_name():
    with pytest.raises(ValueError) as got:
        engine.engine_config("warp")
    with pytest.raises(ValueError) as want:
        jengine.engine_config("warp")
    assert str(got.value) == str(want.value)


def test_registry_holds_the_single_device_engines():
    """The registry holds the reference's six engines, the single-device
    ones and the multi-device ``device`` and ``heap-device``."""
    assert engine.ENGINES == {
        "scan": engine.ScanEngine, "sequential": engine.SequentialEngine,
        "vmap": engine.VmapEngine, "device": engine.ShardMapEngine,
        "heap": engine.HeapEngine, "heap-device": engine.HeapDeviceEngine}
    assert set(engine.ENGINES) == set(jengine.ENGINES)
    for name, cls in engine.ENGINES.items():
        assert cls.backend == name
        assert cls.strategy == jengine.ENGINES[name].strategy


# ----------------------------------------------------------------------
# the streaming API
# ----------------------------------------------------------------------
SMALL = dict(name="eng", image_size=8, conv_layers=1, filters=4,
             fc_layers=1, fc_neurons=32)


def _trainer(m=2, eval_fn=False, faults=None, **tc_kw):
    cfg = cnn.CNNConfig(**SMALL)
    xs, ys = image_dataset(64 * m * 2, size=8, seed=0)
    params = cnn.init_cnn(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    ds = IDPADataset({"images": xs, "labels": ys}, num_nodes=m, batches=1)
    tc_kw.setdefault("outer_strategy", "sgwu")
    tc = TrainConfig(outer_nodes=m, optimizer="adamw", learning_rate=2e-3,
                     total_steps=100, warmup_steps=5, local_steps=2,
                     seed=0, **tc_kw)
    ef = None
    if eval_fn:
        xe, ye = image_dataset(64, size=8, seed=9)
        eb = {"images": torch.from_numpy(xe), "labels": torch.from_numpy(ye)}

        def ef(p):
            return cnn.cnn_accuracy(p, eb, cfg)
    return BPTTrainer(lambda p, b: (cnn.cnn_loss(p, b, cfg), {}), params, ds,
                      tc, batch_size=16, eval_fn=ef, fault_schedule=faults)


@pytest.mark.parametrize("name,events,cadence", [
    ("vmap", 3, 1), ("sequential", 3, 1), ("heap", 6, 2), ("scan", 5, 5)])
def test_event_counts_and_default_eval_cadence(name, events, cadence):
    rounds = 5 if name == "scan" else 3
    tr = _trainer(m=2, eval_fn=True, **engine.engine_config(name))
    seen = []
    rep = tr.train(rounds, TrainHooks(on_round=seen.append))
    assert len(seen) == len(rep.losses) == events
    assert [ev.round for ev in seen] == list(range(events))
    assert tr.last_engine.default_eval_every == cadence
    assert [ev.accuracy is not None for ev in seen] == \
        [(i + 1) % cadence == 0 for i in range(events)]
    assert rep.backend == name and rep.last_event == events
    assert set(rep.summary()) == {"strategy", "backend", "steps",
                                  "final_loss", "final_acc", "makespan",
                                  "sync_wait", "comm_MB"}
    if name == "heap":
        assert all(ev.node in (0, 1) for ev in seen)
    else:
        assert all(ev.node == -1 for ev in seen)


def test_eval_every_override_and_early_stop():
    tr = _trainer(m=2, eval_fn=True, outer_strategy="agwu")
    evs = list(tr.run(3, TrainHooks(eval_every=3)))
    assert [ev.accuracy is not None for ev in evs] == \
        [False, False, True, False, False, True]
    for _ev in tr.run(5):
        break                            # the caller walks away mid-stream
    assert len(tr.train(rounds=2).losses) == 4    # the trainer is reusable


def test_summary_matches_the_reference_keys():
    """A report with a fallback lists it, as the reference's does."""
    tr = _trainer(m=2, outer_strategy="sgwu", device_outer=True)
    rep = tr.train(1)
    assert rep.backend == "vmap" and "have 1" in rep.fallback
    jcfg = jcnn.CNNConfig(**SMALL)
    xs, ys = image_dataset(256, size=8, seed=0)
    jtr = JTrainer(lambda p, b: (jcnn.cnn_loss(p, b, jcfg), {}),
                   jax.tree_util.tree_map(jnp.asarray, jcnn.init_cnn(
                       jax.random.PRNGKey(0), jcfg)),
                   JDataset({"images": xs, "labels": ys}, num_nodes=2,
                            batches=1),
                   JTrainConfig(outer_nodes=2, outer_strategy="sgwu",
                                local_steps=1), batch_size=16)
    jrep = jtr.train(1)
    assert set(rep.summary()) - {"fallback"} == set(jrep.summary())
    assert rep.summary()["fallback"] == rep.fallback


@pytest.mark.parametrize("kw", [{"model_cfg": object()},
                                {"plan_family": "batch"}])
def test_planner_arguments_are_not_ported(kw):
    """The planner's arguments, once refused, are taken and kept as the
    reference keeps them; a trainer without a mesh never reads them."""
    cfg = cnn.CNNConfig(**SMALL)
    params = cnn.init_cnn(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    ds = IDPADataset({"x": np.zeros((8, 1))}, num_nodes=2, batches=1)
    tr = BPTTrainer(lambda p, b: (p, {}), params, ds, TrainConfig(
        outer_nodes=2), batch_size=4, **kw)
    assert tr.model_cfg is kw.get("model_cfg")
    assert tr.plan_family == kw.get("plan_family", "")
    assert tr.devices is None


def test_config_errors_raise_at_the_first_next():
    tr = _trainer(m=2, fused_outer=False, uneven_batches=True)
    with pytest.raises(ValueError, match="uneven"):
        next(iter(tr.run(1)))
    tr = _trainer(m=2, outer_strategy="sync",
                  faults=FaultSchedule.from_spec("fail:1@1"))
    with pytest.raises(ValueError, match="no outer-layer membership"):
        next(iter(tr.run(1)))
    tr = _trainer(m=2, faults=FaultSchedule.from_spec(
        "fail:0@0,fail:1@0"))
    with pytest.raises(RuntimeError, match="no node alive"):
        next(iter(tr.run(1)))
