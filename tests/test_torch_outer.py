"""The port's outer layer (``BPTTrainer`` over its engines) against the
JAX trainer, on the quickstart configuration (``examples/quickstart.py``:
16 px, 2 conv layers of 8, FC 2 x 64; 4 nodes at speeds 1.0-2.2, IDPA
balanced over 3 batches, AdamW at lr 2e-3, 4 local steps, B = 64) from
the same numpy params and data.

The clock is pinned so the runs are deterministic: the stacked SGWU round
reads ``time.perf_counter`` in each package's ``core/engine`` module,
replaced by a stub that steps by a fixed amount a call; the per-node
paths (``sequential``, ``heap``) get fixed per-node durations through the
``_local_round`` seam, as ``tests/test_chaos.py`` pins them.  Then the
allocations, AGWU's node order, the virtual clock, the sync-wait and
Eq. 11's comm bytes must be equal, the losses within rtol 1e-4 / atol
1e-6 and the merged weights within rtol 1e-3 / atol 1e-5 (the tolerances
of ``tests/test_torch_train.py``'s node-round trajectory).  The
trajectories run with ``eval_fn=None`` (Q = 1): an argmax accuracy can
flip on a near tie and move Eq. 7/10's weights; one short run holds the
per-node accuracies of the eval path equal instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import repro.core.engine as jengine  # noqa: E402
from repro.core.bpt_trainer import BPTTrainer as JTrainer  # noqa: E402
from repro.core.faults import FaultSchedule as JFaults  # noqa: E402
from repro.core.types import TrainConfig as JTrainConfig  # noqa: E402
from repro.data.pipeline import IDPADataset as JDataset  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
import repro_torch.core.engine as engine  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.core.bpt_trainer import BPTTrainer  # noqa: E402
from repro_torch.core.faults import FaultSchedule  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.core.types import TrainConfig  # noqa: E402
from repro_torch.data.pipeline import IDPADataset  # noqa: E402
from repro_torch.data.synthetic import image_dataset  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

QUICKSTART = dict(name="quickstart", image_size=16, conv_layers=2,
                  filters=8, fc_layers=2, fc_neurons=64)
SPEEDS = np.array([1.0, 1.3, 1.7, 2.2])
PINNED = 0.01 * SPEEDS             # per-node local-round durations (s)
TICK = 0.05                        # the stub clock's step a call (s)
ENGINES = {"vmap": dict(outer_strategy="sgwu", fused_outer=True),
           "sequential": dict(outer_strategy="sgwu", fused_outer=False),
           "heap": dict(outer_strategy="agwu"),
           "scan": dict(outer_strategy="sync")}


class _Clock:
    """Stands in for the ``time`` module: ``perf_counter`` steps by TICK."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += TICK
        return self.now


def _pin(tr):
    orig = tr._local_round

    def pinned(params, opt_state, node, step):
        p, o, loss, _ = orig(params, opt_state, node, step)
        return p, o, loss, float(PINNED[node])

    tr._local_round = pinned


@pytest.fixture(scope="module")
def setup():
    cfg = jcnn.CNNConfig(**QUICKSTART)
    tree = jax.tree_util.tree_map(
        np.asarray, jcnn.init_cnn(jax.random.PRNGKey(0), cfg))
    xs, ys = image_dataset(2000, size=16, seed=0)
    xe, ye = image_dataset(500, size=16, seed=42)
    return tree, xs, ys, xe, ye


def _trainers(setup, engine_name, faults="", eval_fn=False, **tc_kw):
    """(port trainer, reference trainer) from the same numpy inputs."""
    tree, xs, ys, xe, ye = setup
    kw = dict(**ENGINES[engine_name], outer_nodes=4, optimizer="adamw",
              learning_rate=2e-3, warmup_steps=10, total_steps=400,
              local_steps=4, **tc_kw)
    out = []
    for port in (True, False):
        Dataset, Config, Trainer, Faults = (
            (IDPADataset, TrainConfig, BPTTrainer, FaultSchedule) if port
            else (JDataset, JTrainConfig, JTrainer, JFaults))
        ds = Dataset({"images": xs, "labels": ys}, num_nodes=4, batches=3,
                     frequencies=1.0 / SPEEDS, partitioning="idpa",
                     idpa_mode="balanced")
        if port:
            cfg = cnn.CNNConfig(**QUICKSTART)
            params = weights.params_from_numpy(tree, cfg, "cpu")
            ev = {"images": torch.from_numpy(xe),
                  "labels": torch.from_numpy(ye)}
            loss, acc = cnn.cnn_loss, cnn.cnn_accuracy
        else:
            cfg = jcnn.CNNConfig(**QUICKSTART)
            params = jax.tree_util.tree_map(jnp.asarray, tree)
            ev = {"images": jnp.asarray(xe), "labels": jnp.asarray(ye)}
            loss, acc = jcnn.cnn_loss, jcnn.cnn_accuracy
        tr = Trainer(lambda p, b, loss=loss, cfg=cfg: (loss(p, b, cfg), {}),
                     params, ds, Config(**kw), batch_size=64,
                     eval_fn=(lambda p, acc=acc, cfg=cfg, ev=ev:
                              acc(p, ev, cfg)) if eval_fn else None,
                     speed_factors=SPEEDS,
                     fault_schedule=Faults.from_spec(faults, num_nodes=4)
                     if faults else None)
        if engine_name in ("sequential", "heap"):
            _pin(tr)
        out.append(tr)
    return out


def _run(tr, rounds, monkeypatch, module):
    with monkeypatch.context() as mp:
        mp.setattr(module, "time", _Clock())
        return list(tr.run(rounds))


def _leaves(params):
    if isinstance(tree_leaves(params)[0], torch.Tensor):
        return [x.numpy() for x in tree_leaves(params)]
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


def _assert_same_run(port, ref, tp, tr):
    """Equal bookkeeping, losses and merged weights within tolerance;
    returns the worst weight error of each event."""
    assert len(port) == len(ref)
    worst = []
    for a, b in zip(port, ref):
        assert (a.round, a.node) == (b.round, b.node)
        assert a.virtual_clock == b.virtual_clock
        assert a.sync_wait == b.sync_wait
        assert a.comm_bytes == b.comm_bytes
        np.testing.assert_array_equal(a.durations, b.durations)
        if b.node_status is not None:
            np.testing.assert_array_equal(a.node_status, b.node_status)
        np.testing.assert_allclose(a.node_losses, b.node_losses,
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-4, atol=1e-6)
        err = 0.0
        for x, y in zip(_leaves(a.params), _leaves(b.params), strict=True):
            np.testing.assert_allclose(x, y, rtol=1e-3, atol=1e-5)
            err = max(err, float(np.abs(x - y).max()))
        worst.append(err)
    np.testing.assert_array_equal(tp.dataset.totals, tr.dataset.totals)
    for x, y in zip(tp.dataset.part.history, tr.dataset.part.history,
                    strict=True):
        np.testing.assert_array_equal(x, y)
    assert tp.last_plan.backend == tr.last_plan.backend
    return worst


@pytest.mark.parametrize("engine_name", ["heap", "sequential", "vmap"])
def test_quickstart_matches_the_reference(setup, engine_name, monkeypatch):
    tp, tr = _trainers(setup, engine_name)
    port = _run(tp, 10, monkeypatch, engine)
    ref = _run(tr, 10, monkeypatch, jengine)
    _assert_same_run(port, ref, tp, tr)
    assert len(port) == (40 if engine_name == "heap" else 10)
    if engine_name == "heap":
        order = [ev.node for ev in port]
        assert sorted(set(order)) == [0, 1, 2, 3]
        assert all(ev.sync_wait == 0.0 for ev in port)
    else:
        assert port[-1].sync_wait > 0.0
    # Eq. 11: every round trip is two transfers of the weight set
    c_w = sum(x.numel() * 4 for x in tree_leaves(tp.params0))
    assert port[-1].comm_bytes == 2 * c_w * 4 * 10


@pytest.mark.parametrize("engine_name", ["vmap", "heap"])
def test_fault_schedule_matches_the_reference(setup, engine_name,
                                              monkeypatch):
    spec = "fail:1@2,rejoin:1@8"
    tp, tr = _trainers(setup, engine_name, faults=spec)
    rounds = 10 if engine_name == "vmap" else 4
    port = _run(tp, rounds, monkeypatch, engine)
    ref = _run(tr, rounds, monkeypatch, jengine)
    _assert_same_run(port, ref, tp, tr)
    status = [ev.node_status[1] for ev in port]
    assert 0.0 in status and status[-1] == 1.0


def test_sync_baseline_matches_the_reference(setup, monkeypatch):
    tp, tr = _trainers(setup, "scan")
    port = _run(tp, 5, monkeypatch, engine)
    ref = _run(tr, 5, monkeypatch, jengine)
    _assert_same_run(port, ref, tp, tr)
    assert port[-1].virtual_clock == pytest.approx(5 * TICK)


def test_eval_path_accuracies_are_equal(setup, monkeypatch):
    """The quickstart's ``eval_fn``: the per-node accuracies that weight
    Eq. 7 and the merged weights' accuracy agree exactly."""
    tp, tr = _trainers(setup, "vmap", eval_fn=True)
    seen = {}
    for key, t in (("port", tp), ("ref", tr)):
        orig, seen[key] = t._eval_nodes, []
        t._eval_nodes = lambda s, orig=orig, out=seen[key]: (
            out.append(orig(s)) or out[-1])
    port = _run(tp, 2, monkeypatch, engine)
    ref = _run(tr, 2, monkeypatch, jengine)
    _assert_same_run(port, ref, tp, tr)
    assert seen["port"] == seen["ref"]
    assert [ev.accuracy for ev in port] == [ev.accuracy for ev in ref]


def test_pallas_reference_matches(setup, monkeypatch):
    """The reference through its Pallas kernels (interpret mode on the
    CPU), two rounds."""
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "pallas")
    tp, tr = _trainers(setup, "sequential")
    port = _run(tp, 2, monkeypatch, engine)
    ref = _run(tr, 2, monkeypatch, jengine)
    _assert_same_run(port, ref, tp, tr)


# ----------------------------------------------------------------------
# the stacked round against the per-node loop, inside the port
# ----------------------------------------------------------------------
def _run_sgwu(m, fused, rounds=3):
    """tests/test_bpt_fused.py's run: batches=1 freezes the allocation so
    both paths see identical data whatever the wall time."""
    cfg = cnn.CNNConfig(name="equiv", image_size=8, conv_layers=1,
                        filters=4, fc_layers=1, fc_neurons=32)
    xs, ys = image_dataset(64 * m * 2, size=8, seed=0)
    params = cnn.init_cnn(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    ds = IDPADataset({"images": xs, "labels": ys}, num_nodes=m, batches=1)
    tc = TrainConfig(outer_strategy="sgwu", outer_nodes=m,
                     optimizer="adamw", learning_rate=2e-3,
                     total_steps=100, warmup_steps=5, local_steps=2,
                     seed=0, fused_outer=fused)
    tr = BPTTrainer(lambda p, b: (cnn.cnn_loss(p, b, cfg), {}), params, ds,
                    tc, batch_size=32)
    return tr.train(rounds=rounds)


@pytest.mark.parametrize("m", [1, 4])
def test_stacked_round_equals_the_per_node_loop(m):
    fused, seq = _run_sgwu(m, True), _run_sgwu(m, False)
    assert (fused.backend, seq.backend) == ("vmap", "sequential")
    np.testing.assert_allclose(fused.losses, seq.losses, rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(tree_leaves(fused.final_params),
                    tree_leaves(seq.final_params), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    assert fused.comm_bytes == seq.comm_bytes
