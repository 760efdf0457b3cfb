"""The port's event-driven cluster simulator (``repro_torch.core.cluster_sim``)
against the reference's (``repro.core.cluster_sim``), and the reference's
own metric-level cases (``tests/test_cluster_sim.py``) on the port.

On the same seeds and per-sample times the virtual metrics must be equal:
makespan, sync-wait, Eq. 11's comm bytes and their closed form, the
balance degree and the allocation, for SGWU and AGWU under IDPA and UDPA
(with duration noise, and with a fault schedule).  With a ``worker_train``
that trains the chaos CNN one SGD step on the node's stripe in each
package from the same numpy params, the final weights must agree within
the outer layer's tolerances (rtol 1e-3 / atol 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.core import cluster_sim as jsim  # noqa: E402
from repro.core.faults import FaultSchedule as JFaults  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.core.bpt_trainer import value_and_grad  # noqa: E402
from repro_torch.core.cluster_sim import (ClusterSim,  # noqa: E402
                                          make_heterogeneous_speeds)
from repro_torch.core.faults import FaultSchedule  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.data.synthetic import image_dataset  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

CHAOS = dict(name="chaos", image_size=8, conv_layers=1, filters=4,
             fc_layers=1, fc_neurons=32)


def _metrics(res):
    return (res.makespan, res.sync_wait, res.comm_bytes,
            res.expected_comm_bytes, res.balance_degree,
            res.allocation.tolist())


def test_speeds_match_the_reference():
    for m, spread, seed in ((6, 0.8, 0), (3, 0.5, 7)):
        np.testing.assert_array_equal(
            make_heterogeneous_speeds(m, spread, seed),
            jsim.make_heterogeneous_speeds(m, spread, seed))


@pytest.mark.parametrize("partitioning", ["idpa", "udpa"])
@pytest.mark.parametrize("strategy", ["sgwu", "agwu"])
@pytest.mark.parametrize("noise,faults", [(0.0, ""), (0.3, ""),
                                          (0.0, "fail:1@3,rejoin:1@5")],
                         ids=["plain", "noise", "churn"])
def test_metrics_equal_the_reference(strategy, partitioning, noise, faults):
    m = 5
    t = make_heterogeneous_speeds(m, 0.8, 3)
    kw = dict(iterations=8, batches=4, strategy=strategy,
              partitioning=partitioning, noise=noise, seed=3,
              idpa_mode="balanced")
    got = ClusterSim(5000, t, fault_schedule=FaultSchedule.from_spec(
        faults, num_nodes=m) if faults else None, **kw).run()
    want = jsim.ClusterSim(5000, t, fault_schedule=JFaults.from_spec(
        faults, num_nodes=m) if faults else None, **kw).run()
    assert _metrics(got) == _metrics(want)
    assert got.summary() == want.summary()


@pytest.fixture(scope="module")
def cnn_setup():
    jcfg = jcnn.CNNConfig(**CHAOS)
    tree = jax.tree_util.tree_map(
        np.asarray, jcnn.init_cnn(jax.random.PRNGKey(0), jcfg))
    xs, ys = image_dataset(300, size=8, seed=0)
    return tree, xs, ys


LR = 0.05
STEP_ROWS = 16


def _port_worker(xs, ys):
    cfg = cnn.CNNConfig(**CHAOS)

    def worker_train(j, w, idx, it):
        rows = idx[:STEP_ROWS]
        batch = {"images": torch.from_numpy(xs[rows]),
                 "labels": torch.from_numpy(ys[rows])}
        _, g = value_and_grad(lambda p, b: (cnn.cnn_loss(p, b, cfg), {}),
                              w, batch)
        return tree_map(lambda p, d: p - LR * d, w, g), 1.0
    return worker_train


def _ref_worker(xs, ys):
    cfg = jcnn.CNNConfig(**CHAOS)
    grad = jax.jit(jax.grad(lambda p, b: jcnn.cnn_loss(p, b, cfg)))

    def worker_train(j, w, idx, it):
        rows = idx[:STEP_ROWS]
        g = grad(w, {"images": jnp.asarray(xs[rows]),
                     "labels": jnp.asarray(ys[rows])})
        return jax.tree_util.tree_map(lambda p, d: p - LR * d, w, g), 1.0
    return worker_train


@pytest.mark.parametrize("strategy", ["sgwu", "agwu"])
def test_trained_weights_match_the_reference(cnn_setup, strategy):
    """Real weight math on both sides: the CNN trained one SGD step a
    work unit on each node's stripe; the port's worker receives and
    returns trees of tensors on the caller's device (the CPU here)."""
    tree, xs, ys = cnn_setup
    t = np.array([1.0, 1.4, 2.0])
    kw = dict(iterations=3, batches=2, strategy=strategy,
              partitioning="idpa")
    cfg = cnn.CNNConfig(**CHAOS)
    got = ClusterSim(len(xs), t, **kw).run(
        init_weights=weights.params_from_numpy(tree, cfg, "cpu"),
        worker_train=_port_worker(xs, ys))
    want = jsim.ClusterSim(len(xs), t, **kw).run(
        init_weights=jax.tree_util.tree_map(jnp.asarray, tree),
        worker_train=_ref_worker(xs, ys))
    assert _metrics(got) == _metrics(want)
    leaves = tree_leaves(got.final_weights)
    assert all(x.device.type == "cpu" for x in leaves)
    for a, b in zip(leaves, jax.tree_util.tree_leaves(want.final_weights),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-5)
    # the weights moved: the merges applied the workers' steps
    assert any(not np.array_equal(a.numpy(), np.asarray(b))
               for a, b in zip(leaves, jax.tree_util.tree_leaves(tree)))


# ----------------------------------------------------------------------
# the reference's own cases (tests/test_cluster_sim.py), on the port
# ----------------------------------------------------------------------
def run(strategy, partitioning, m=6, N=6000, K=8, A=4, spread=0.8, seed=0,
        idpa_mode="paper"):
    t = make_heterogeneous_speeds(m, spread, seed)
    sim = ClusterSim(N, t, iterations=K, batches=A, strategy=strategy,
                     partitioning=partitioning, idpa_mode=idpa_mode)
    return sim.run()


class TestSyncWait:
    def test_agwu_has_zero_sync_wait(self):
        assert run("agwu", "idpa").sync_wait == 0.0

    def test_sgwu_waits_on_heterogeneous_cluster(self):
        assert run("sgwu", "udpa").sync_wait > 0.0

    def test_idpa_reduces_sgwu_wait(self):
        w_udpa = run("sgwu", "udpa").sync_wait
        w_idpa = run("sgwu", "idpa", idpa_mode="balanced").sync_wait
        assert w_idpa < w_udpa


class TestCommunication:
    def test_eq11_both_strategies_equal(self):
        a = run("agwu", "idpa")
        s = run("sgwu", "idpa")
        assert a.comm_bytes == s.comm_bytes == a.expected_comm_bytes

    def test_comm_scales_linearly_with_nodes(self):
        c5 = run("agwu", "idpa", m=5).comm_bytes / 5
        c10 = run("agwu", "idpa", m=10).comm_bytes / 10
        assert c5 == pytest.approx(c10)


class TestWorkloadBalance:
    def test_idpa_beats_udpa_balance(self):
        b_idpa = run("agwu", "idpa", idpa_mode="balanced").balance_degree
        b_udpa = run("agwu", "udpa").balance_degree
        assert b_idpa > b_udpa

    def test_balance_in_unit_interval(self):
        for strat in ("agwu", "sgwu"):
            r = run(strat, "idpa")
            assert 0 < r.balance_degree <= 1.0


class TestMakespan:
    def test_agwu_idpa_fastest(self):
        fast = run("agwu", "idpa", idpa_mode="balanced").makespan
        slow = run("sgwu", "udpa").makespan
        assert fast < slow

    @settings(max_examples=15, deadline=None)
    @given(m=st.integers(2, 10), seed=st.integers(0, 50))
    def test_makespan_positive_and_allocation_complete(self, m, seed):
        r = run("agwu", "idpa", m=m, seed=seed)
        assert r.makespan > 0
        assert r.allocation.sum() == (6000 // 4) * 4


class TestIDPAFeedbackSignal:
    def test_agwu_feeds_charged_durations_not_fresh_rolls(self):
        m, K = 3, 4
        sim = ClusterSim(600, np.ones(m), iterations=K, batches=2,
                         strategy="agwu", partitioning="idpa", noise=0.5)
        calls = []
        orig = sim._duration

        def counting(node, nsamples):
            calls.append(node)
            return orig(node, nsamples)

        sim._duration = counting
        res = sim.run()
        assert res.makespan > 0
        assert len(calls) == m * K

    def test_agwu_allocation_tracks_observed_load(self):
        t = np.array([1.0, 1.0, 3.0])
        sim = ClusterSim(900, t, iterations=6, batches=3,
                         strategy="agwu", partitioning="idpa",
                         idpa_mode="balanced", noise=0.2, seed=2)
        res = sim.run()
        assert res.allocation[2] < res.allocation[0]
        assert res.allocation[2] < res.allocation[1]


class TestRealTraining:
    def test_weight_math_is_applied(self):
        w0 = {"w": torch.zeros(4)}

        def worker_train(j, w, idx, it):
            return {"w": w["w"] + 1.0}, 0.9

        sim = ClusterSim(300, np.ones(3), iterations=2, batches=2,
                         strategy="agwu", partitioning="idpa")
        res = sim.run(init_weights=w0, worker_train=worker_train)
        assert float(res.final_weights["w"].sum()) > 0

    def test_measured_durations_need_a_worker(self):
        sim = ClusterSim(300, np.ones(3), iterations=2, batches=2,
                         duration_source="measured")
        with pytest.raises(ValueError, match="needs a worker_train"):
            sim.run()
