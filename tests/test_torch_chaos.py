"""The port's chaos suite, from ``tests/test_chaos.py``: the elastic outer
layer under node churn and process death, on the CPU.

* **Churn convergence** — kill k=2 of m=8 nodes mid-training under the
  heap (AGWU), vmap and device-sharded (SGWU) engines, the last on a pool
  of eight CPU devices; training must still converge to the fault-free
  trajectory within ``CHURN_LOSS_TOL``.
* **Crash-safe resumption** — in-process: break the event stream, build a
  fresh trainer, resume from the state checkpoint, and require the final
  merged weights and the loss trail BIT-identical to an uninterrupted run
  (``scan``, ``vmap``, ``sequential``, ``heap``, and on a pool of CPU
  devices ``device`` and ``heap-device``).  Out-of-process:
  SIGKILL ``tests/torch_chaos_worker.py`` between rounds and require the
  resumed process's final weights within 1e-5 of the worker's job run
  uninterrupted (exact on the CPU).
* **Across the packages** — a state checkpoint the JAX trainer wrote at
  event 4 resumes in the port and the other way round (``vmap``, and
  ``heap`` with durations pinned), each finishing within
  ``tests/test_torch_outer.py``'s tolerances of the other package's
  uninterrupted run: losses rtol 1e-4 / atol 1e-6, weights rtol 1e-3 /
  atol 1e-5, Eq. 11's comm bytes equal.
* **Measured-duration IDPA** and **adversarial AGWU heaps**, as in the
  reference, with its pinned Eq. 10 gamma traces.

AGWU's virtual clock is built from measured wall times, so its pop order
is timing-dependent run to run; every heap assertion here pins per-node
durations (``_pin_durations``).
"""
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from torch_chaos_worker import FINAL_STEP, build_trainer  # noqa: E402

import repro.core.engine as jengine  # noqa: E402
from repro.core.bpt_trainer import BPTTrainer as JTrainer  # noqa: E402
from repro.core.bpt_trainer import TrainHooks as JHooks  # noqa: E402
from repro.core.types import TrainConfig as JTrainConfig  # noqa: E402
from repro.data.pipeline import IDPADataset as JDataset  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
import repro_torch.core.engine as engine  # noqa: E402
import repro_torch.core.param_server as param_server_module  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.checkpointing import checkpoint  # noqa: E402
from repro_torch.core.bpt_trainer import BPTTrainer, TrainHooks  # noqa: E402
from repro_torch.core.faults import FaultEvent, FaultSchedule  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.core.types import TrainConfig  # noqa: E402
from repro_torch.data.pipeline import IDPADataset  # noqa: E402
from repro_torch.data.synthetic import image_dataset  # noqa: E402
from repro_torch.models.cnn import CNNConfig, cnn_loss, init_cnn  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# documented tolerance for the churn-vs-reference final loss: losing 2 of
# 8 nodes drops those nodes' minibatches from a handful of merges, which
# perturbs — but must not derail — the trajectory
CHURN_LOSS_TOL = 0.25
CHAOS = dict(name="chaos", image_size=8, conv_layers=1, filters=4,
             fc_layers=1, fc_neurons=32)


def _make_trainer(m=4, batches=1, faults=None, speed_factors=None,
                  seed=0, devices=None, **tc_kwargs):
    cfg = CNNConfig(**CHAOS)
    xs, ys = image_dataset(64 * m * 2, size=8, seed=0)
    params = init_cnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    ds = IDPADataset({"images": xs, "labels": ys}, num_nodes=m,
                     batches=batches)
    tc_kwargs.setdefault("outer_strategy", "sgwu")
    tc = TrainConfig(outer_nodes=m, optimizer="adamw", learning_rate=2e-3,
                     total_steps=100, warmup_steps=5, local_steps=2,
                     seed=seed, **tc_kwargs)
    return BPTTrainer(lambda p, b: (cnn_loss(p, b, cfg), {}), params, ds,
                      tc, batch_size=16, fault_schedule=faults,
                      speed_factors=speed_factors, devices=devices)


ENGINE_KW = {
    "vmap": dict(outer_strategy="sgwu", fused_outer=True),
    "sequential": dict(outer_strategy="sgwu", fused_outer=False),
    "heap": dict(outer_strategy="agwu"),
    "scan": dict(outer_strategy="sync"),
    # the multi-device engines, on a pool of one CPU device per node
    "device": dict(outer_strategy="sgwu", device_outer=True,
                   devices=[torch.device("cpu")] * 8),
    "heap-device": dict(outer_strategy="agwu", device_outer=True,
                        devices=[torch.device("cpu")] * 8),
}
HEAPS = ("heap", "heap-device")


def _pin_durations(tr, per_node):
    """Replace measured wall durations with fixed per-node values so the
    AGWU heap order (and hence the weight math) is deterministic."""
    per_node = np.asarray(per_node, dtype=np.float64)
    orig = tr._local_round

    def pinned(params, opt_state, node, step):
        p, o, loss, _ = orig(params, opt_state, node, step)
        return p, o, loss, float(per_node[node])

    tr._local_round = pinned


def _drain(tr, rounds, hooks=None):
    return list(tr.run(rounds, hooks))


def _final_weights(ev):
    return [x.numpy() for x in tree_leaves(ev.params)]


def _max_diff(ws_a, ws_b):
    return max(float(np.abs(a - b).max())
               for a, b in zip(ws_a, ws_b, strict=True))


# ----------------------------------------------------------------------
# churn convergence: kill k=2 of m=8 mid-training
# ----------------------------------------------------------------------
class TestChurnConvergence:
    @pytest.mark.parametrize("seed", [0, 1])
    @pytest.mark.parametrize("engine_name", ["heap", "vmap", "device"])
    def test_k2_of_m8_converges_to_reference(self, engine_name, seed):
        m, rounds = 8, 4
        # heap indices are push counts (m per virtual round); barrier
        # indices are rounds — both kill nodes 2 and 5 early in the run
        spec = "fail:2@4,fail:5@8" if engine_name == "heap" \
            else "fail:2@1,fail:5@2"
        faults = FaultSchedule.from_spec(spec, num_nodes=m)

        ref = _make_trainer(m=m, seed=seed, **ENGINE_KW[engine_name])
        churn = _make_trainer(m=m, seed=seed, faults=faults,
                              **ENGINE_KW[engine_name])
        if engine_name == "heap":
            durs = 1.0 + 0.1 * np.arange(m)
            _pin_durations(ref, durs)
            _pin_durations(churn, durs)

        ref_events = _drain(ref, rounds)
        churn_events = _drain(churn, rounds)

        assert churn_events, "churn run produced no events"
        if engine_name == "heap":
            assert len(churn_events) < len(ref_events)
            dead_after = {2: 4, 5: 8}
            for ev in churn_events:
                for node, cutoff in dead_after.items():
                    assert not (ev.node == node and ev.round >= cutoff), \
                        f"dead node {node} pushed at event {ev.round}"
        ref_loss = ref_events[-1].loss
        churn_loss = churn_events[-1].loss
        assert np.isfinite(churn_loss)
        assert abs(churn_loss - ref_loss) < CHURN_LOSS_TOL, \
            (f"{engine_name}: churn final loss {churn_loss:.4f} diverged "
             f"from reference {ref_loss:.4f} beyond {CHURN_LOSS_TOL}")
        losses = [ev.loss for ev in churn_events]
        half = len(losses) // 2
        assert np.mean(losses[half:]) < np.mean(losses[:half]) + 0.05

    def test_rejoined_node_pushes_again(self):
        m = 4
        faults = FaultSchedule.from_spec("fail:1@2,rejoin:1@8", num_nodes=m)
        tr = _make_trainer(m=m, faults=faults, outer_strategy="agwu")
        _pin_durations(tr, np.ones(m))
        events = _drain(tr, 4)
        dead_window = [ev for ev in events if 2 <= ev.round < 8]
        assert all(ev.node != 1 for ev in dead_window)
        assert any(ev.node == 1 and ev.round >= 8 for ev in events), \
            "rejoined node never pushed again"
        assert len(events) == 4 * m

    def test_all_dead_raises(self):
        faults = FaultSchedule.from_spec("fail:0@1,fail:1@1", num_nodes=2)
        tr = _make_trainer(m=2, faults=faults, fused_outer=True)
        with pytest.raises(RuntimeError, match="leaves no node alive"):
            _drain(tr, 3)


# ----------------------------------------------------------------------
# node_status / durations observability on the event stream
# ----------------------------------------------------------------------
class TestNodeStatusObservability:
    def test_barrier_status_and_slow_durations(self):
        m = 4
        faults = FaultSchedule(
            [FaultEvent(round=1, node=0, kind="slow", factor=3.0),
             FaultEvent(round=2, node=2, kind="fail")], num_nodes=m)
        tr = _make_trainer(m=m, faults=faults, fused_outer=True)
        events = _drain(tr, 4)
        assert all(ev.node_status is not None for ev in events)
        assert np.all(events[0].node_status == 1.0)
        assert events[1].node_status[0] == 3.0
        assert events[2].node_status[2] == 0.0
        d = events[1].durations
        assert np.isclose(d[0] / d[1], 3.0)
        assert events[2].durations[2] == 0.0

    def test_churn_free_runs_emit_no_status(self):
        tr = _make_trainer(m=2, fused_outer=True)
        events = _drain(tr, 2)
        assert all(ev.node_status is None for ev in events)
        assert all(ev.durations is not None for ev in events)

    def test_dead_node_not_charged_comm(self):
        m = 4
        faults = FaultSchedule.from_spec("fail:3@1", num_nodes=m)
        tr = _make_trainer(m=m, faults=faults, fused_outer=True)
        events = _drain(tr, 3)
        per_round = np.diff([0] + [ev.comm_bytes for ev in events])
        wb = events[0].comm_bytes // (2 * m)
        assert per_round[0] == 2 * m * wb
        assert per_round[1] == 2 * (m - 1) * wb
        assert per_round[2] == 2 * (m - 1) * wb


# ----------------------------------------------------------------------
# in-process crash/resume: bit-identical continuation
# ----------------------------------------------------------------------
class TestCrashResume:
    @pytest.mark.parametrize("engine_name",
                             ["vmap", "sequential", "heap", "scan",
                              "device", "heap-device"])
    def test_resume_is_bit_identical(self, engine_name, tmp_path):
        rounds, m = 6, 4
        kw = ENGINE_KW[engine_name]
        durs = 1.0 + 0.25 * np.arange(m)

        def make():
            tr = _make_trainer(m=m, **kw)
            if engine_name in HEAPS:
                _pin_durations(tr, durs)
            return tr

        ref = make()
        ref_events = _drain(ref, rounds)
        assert ref.last_plan.backend == engine_name

        # crash: consume part of the stream, then abandon the trainer
        crashed = make()
        hooks = TrainHooks(checkpoint_every=2, checkpoint_dir=str(tmp_path))
        consumed = 0
        stop_at = 8 if engine_name in HEAPS else 3
        for _ev in crashed.run(rounds, hooks):
            consumed += 1
            if consumed >= stop_at:
                break

        # resume: a FRESH trainer (fresh RNG, fresh dataset, fresh engine)
        hooks2 = TrainHooks(checkpoint_every=2,
                            checkpoint_dir=str(tmp_path), resume=True)
        res_events = _drain(make(), rounds, hooks2)

        last_ckpt = (stop_at // 2) * 2
        assert len(res_events) == len(ref_events) - last_ckpt
        diff = _max_diff(_final_weights(ref_events[-1]),
                         _final_weights(res_events[-1]))
        assert diff == 0.0, \
            f"{engine_name}: resumed weights differ from uninterrupted " \
            f"(max abs diff {diff:.3e})"
        assert [ev.loss for ev in ref_events[last_ckpt:]] == \
            [ev.loss for ev in res_events]
        # the state checkpoint holds the reference's scalar keys
        scalars = checkpoint.load_manifest(str(tmp_path), last_ckpt,
                                           kind="state")["metadata"]
        heap_keys = {"clock", "heap", "rounds_done", "node_durs", "down",
                     "slow", "epoch", "fault_cursor", "server"}
        want = {"scan": {"clock"}, "heap": heap_keys,
                "heap-device": heap_keys
                }.get(engine_name, {"clock", "sync_wait", "server"})
        assert set(scalars) == want | {"trainer"}
        assert set(scalars["trainer"]) == {"next_event", "rng", "dataset",
                                           "q_ema"}

    def test_resume_with_empty_dir_starts_fresh(self, tmp_path):
        tr = _make_trainer(m=2, fused_outer=True)
        hooks = TrainHooks(checkpoint_every=2,
                           checkpoint_dir=str(tmp_path / "fresh"),
                           resume=True)
        events = _drain(tr, 3, hooks)
        assert len(events) == 3
        assert checkpoint.latest_step(str(tmp_path / "fresh"),
                                      kind="state") == 2

    def test_resume_restores_server_log_and_idpa_state(self, tmp_path):
        """The state checkpoint carries the parameter-server bookkeeping
        and the IDPA allocation state — a resumed run CONTINUES the comm
        accounting and the incremental allocation."""
        m, rounds = 4, 6
        tr = _make_trainer(m=m, batches=2, fused_outer=True)
        hooks = TrainHooks(checkpoint_every=2, checkpoint_dir=str(tmp_path))
        consumed = 0
        for _ev in tr.run(rounds, hooks):
            consumed += 1
            if consumed >= 4:     # state checkpoint for event 4 on disk
                break

        tr2 = _make_trainer(m=m, batches=2, fused_outer=True)
        hooks2 = TrainHooks(checkpoint_every=2,
                            checkpoint_dir=str(tmp_path), resume=True)
        events = _drain(tr2, rounds, hooks2)
        assert len(events) == rounds - 4
        wb = events[0].comm_bytes // (2 * m * 5)
        assert events[0].comm_bytes == 2 * m * 5 * wb
        assert events[-1].comm_bytes == 2 * m * rounds * wb
        assert tr2.last_engine is not None
        part = tr2.dataset.part
        assert part.done and len(part.history) == part.num_batches
        assert tr2.dataset.totals.sum() == \
            part.batch_size * part.num_batches

# ----------------------------------------------------------------------
# out-of-process: SIGKILL between rounds, resume losslessly
# ----------------------------------------------------------------------
class TestSigkill:
    def _spawn(self, ckpt_dir, resume=False, rounds=6):
        cmd = [sys.executable, str(REPO / "tests" / "torch_chaos_worker.py"),
               "--ckpt-dir", str(ckpt_dir), "--rounds", str(rounds),
               "--device", "cpu"]
        if resume:
            cmd.append("--resume")
        env = dict(os.environ)
        env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + \
            env.get("PYTHONPATH", "")
        # one intra-op thread, as this module's own runs (torch_threads)
        env["OMP_NUM_THREADS"] = "1"
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                                env=env)

    def test_sigkill_between_rounds_resumes_losslessly(self, tmp_path):
        kill_dir = tmp_path / "kill"
        rounds = 6
        # the worker's job uninterrupted, in this process
        ref = list(build_trainer(4).run(rounds))[-1].params

        # victim: SIGKILL after it reports event 2 (its checkpoint for
        # event 2 is on disk before the line is printed)
        p = self._spawn(kill_dir, rounds=rounds)
        seen = 0
        deadline = time.time() + 600
        for line in p.stdout:
            if line.startswith("EVENT"):
                seen += 1
                if seen >= 3:
                    os.kill(p.pid, signal.SIGKILL)
                    break
            assert time.time() < deadline
        p.wait(timeout=60)
        p.stdout.close()
        assert p.returncode != 0, "victim was supposed to die"
        assert checkpoint.latest_step(str(kill_dir)) is not None
        assert checkpoint.latest_step(str(kill_dir), kind="state") \
            is not None

        p = self._spawn(kill_dir, resume=True, rounds=rounds)
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0 and "DONE" in out
        assert "EVENT 0" not in out          # it resumed, it did not restart

        w_res, _ = checkpoint.restore(str(kill_dir), ref, step=FINAL_STEP)
        diff = _max_diff([x.numpy() for x in tree_leaves(ref)],
                         [x.numpy() for x in tree_leaves(w_res)])
        assert diff <= 1e-5, f"resumed run diverged: max diff {diff:.3e}"
        assert diff == 0.0                   # exact on the CPU


# ----------------------------------------------------------------------
# state checkpoints across the packages
# ----------------------------------------------------------------------
TICK = 0.05


class _Clock:
    """Stands in for an engine module's ``time``: ``perf_counter`` steps
    by TICK a call, so every stacked round's wall is fixed."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += TICK
        return self.now


@pytest.fixture(scope="module")
def chaos_tree():
    cfg = jcnn.CNNConfig(**CHAOS)
    return jax.tree_util.tree_map(
        np.asarray, jcnn.init_cnn(jax.random.PRNGKey(0), cfg))


def _pair_trainer(tree, engine_name, port):
    """A port or a JAX trainer from the same numpy params and data."""
    m = 4
    xs, ys = image_dataset(64 * m * 2, size=8, seed=0)
    kw = dict(**ENGINE_KW[engine_name], outer_nodes=m, optimizer="adamw",
              learning_rate=2e-3, total_steps=100, warmup_steps=5,
              local_steps=2, seed=0)
    devices = kw.pop("devices", None)
    if port:
        cfg = CNNConfig(**CHAOS)
        tr = BPTTrainer(lambda p, b: (cnn_loss(p, b, cfg), {}),
                        weights.params_from_numpy(tree, cfg, "cpu"),
                        IDPADataset({"images": xs, "labels": ys},
                                    num_nodes=m, batches=1),
                        TrainConfig(**kw), batch_size=16, devices=devices)
    else:
        cfg = jcnn.CNNConfig(**CHAOS)
        tr = JTrainer(lambda p, b: (jcnn.cnn_loss(p, b, cfg), {}),
                      jax.tree_util.tree_map(jnp.asarray, tree),
                      JDataset({"images": xs, "labels": ys}, num_nodes=m,
                               batches=1),
                      JTrainConfig(**kw), batch_size=16)
    if engine_name in HEAPS:
        _pin_durations(tr, 1.0 + 0.25 * np.arange(m))
    return tr


def _leaves(params):
    leaves = tree_leaves(params)
    if isinstance(leaves[0], torch.Tensor):
        return [x.numpy() for x in leaves]
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


def _resume_across(tree, names, writer, tmp_path, monkeypatch):
    """The writer package's run checkpointed at every event and stopped at
    event 4, resumed by the other package; returns (the resumed tail, the
    reader's uninterrupted run from event 4).  ``names`` maps a package
    to its engine."""
    rounds, split = (4 if names["jax"] == "heap" else 6), 4
    mods = {"jax": jengine, "port": engine}
    hooks = {"jax": JHooks, "port": TrainHooks}
    reader = "port" if writer == "jax" else "jax"
    for module in mods.values():
        monkeypatch.setattr(module, "time", _Clock())
    # the reader's uninterrupted run
    ref = list(_pair_trainer(tree, names[reader],
                             reader == "port").run(rounds))
    for module in mods.values():
        monkeypatch.setattr(module, "time", _Clock())
    # the writer's run, checkpointing at every event, stopped at `split`
    h = hooks[writer](checkpoint_every=1, checkpoint_dir=str(tmp_path))
    wrote = _pair_trainer(tree, names[writer], writer == "port")
    for ev in wrote.run(rounds, h):
        if ev.round + 1 == split:
            break
    assert checkpoint.latest_step(str(tmp_path), kind="state") == split
    # the reader resumes it
    h = hooks[reader](checkpoint_every=1, checkpoint_dir=str(tmp_path),
                      resume=True)
    tail = list(_pair_trainer(tree, names[reader],
                              reader == "port").run(rounds, h))
    return tail, ref[split:]


@pytest.mark.parametrize("engine_name", ["vmap", "heap"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_state_checkpoint_resumes_across_packages(chaos_tree, engine_name,
                                                  writer, tmp_path,
                                                  monkeypatch):
    tail, want = _resume_across(chaos_tree, {"jax": engine_name,
                                             "port": engine_name},
                                writer, tmp_path, monkeypatch)
    _assert_tail(tail, want)


@pytest.mark.parametrize("port_engine,jax_engine",
                         [("device", "vmap"), ("heap-device", "heap")])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_device_state_checkpoint_resumes_across_packages(
        chaos_tree, port_engine, jax_engine, writer, tmp_path, monkeypatch):
    """The multi-device engines snapshot in the reference's format: the
    port's ``device`` (on four CPU devices) and the JAX package's ``vmap``
    share the stacked SGWU state, the port's ``heap-device`` and the JAX
    ``heap`` the AGWU state (node j's base in ``base``), so each resumes
    the other's state checkpoint."""
    tail, want = _resume_across(chaos_tree, {"jax": jax_engine,
                                             "port": port_engine},
                                writer, tmp_path, monkeypatch)
    _assert_tail(tail, want)


def _assert_tail(tail, want):
    """The resumed tail within ``tests/test_torch_outer.py``'s
    tolerances of the reader's uninterrupted run, event for event."""
    assert len(tail) == len(want) > 0
    for a, b in zip(tail, want):
        assert (a.round, a.node) == (b.round, b.node)
        assert a.comm_bytes == b.comm_bytes
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(a.node_losses, b.node_losses, rtol=1e-4,
                                   atol=1e-6)
        for x, y in zip(_leaves(a.params), _leaves(b.params), strict=True):
            np.testing.assert_allclose(x, y, rtol=1e-3, atol=1e-5)


def test_heap_extends_a_completed_run_as_the_reference(chaos_tree,
                                                        tmp_path):
    """A larger ``rounds`` continues a completed AGWU run: both packages
    re-seed the restored heap at the restored clock, so the extension's
    pushes (node, clock, Eq. 11 bytes, losses) are the reference's."""
    runs = {}
    for pkg, Hooks in (("port", TrainHooks), ("jax", JHooks)):
        d = str(tmp_path / pkg)
        hooks = Hooks(checkpoint_every=1, checkpoint_dir=d, resume=True)
        first = list(_pair_trainer(chaos_tree, "heap", pkg == "port")
                     .run(2, hooks))
        again = list(_pair_trainer(chaos_tree, "heap", pkg == "port")
                     .run(2, hooks))
        more = list(_pair_trainer(chaos_tree, "heap", pkg == "port")
                    .run(3, hooks))
        assert len(first) == 8 and again == []    # resumed past the end
        assert [ev.round for ev in more] == list(range(8, 12))
        assert sorted(ev.node for ev in more) == [0, 1, 2, 3]
        assert checkpoint.latest_step(d, kind="state") == 12
        runs[pkg] = more
    for a, b in zip(runs["port"], runs["jax"], strict=True):
        assert (a.node, a.virtual_clock, a.comm_bytes) == \
            (b.node, b.virtual_clock, b.comm_bytes)
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-4, atol=1e-6)


# ----------------------------------------------------------------------
# measured-duration IDPA: allocation follows observed speed
# ----------------------------------------------------------------------
class TestMeasuredDurationIDPA:
    def test_slow_node_gets_smaller_allocation(self):
        m = 4
        speeds = np.array([1.0, 1.0, 1.0, 6.0])   # node 3: 6x slower
        tr = _make_trainer(m=m, batches=2, fused_outer=True,
                           speed_factors=speeds)
        events = _drain(tr, 3)
        part = tr.dataset.part
        assert part.done and len(part.history) == 2
        inc = part.history[1]
        assert inc[3] < inc[0]
        assert inc[3] < part.history[0][3]
        assert events[0].durations is not None
        assert events[0].durations[3] > 3 * events[0].durations[0]

    def test_slow_fault_shrinks_heap_allocation(self):
        m = 4
        faults = FaultSchedule.from_spec("slow:0@2x8.0", num_nodes=m)
        tr = _make_trainer(m=m, batches=3, outer_strategy="agwu",
                           faults=faults)
        _pin_durations(tr, np.ones(m))
        _drain(tr, 4)
        part = tr.dataset.part
        assert part.done and len(part.history) == 3
        assert abs(part.history[1][0] - part.history[1][1]) <= 1
        inc = part.history[2]
        assert inc[0] < inc[1], \
            "slowed node kept its allocation share despite 8x durations"

    def test_dead_node_keeps_stripe_gets_no_increment(self):
        m = 4
        faults = FaultSchedule.from_spec("fail:2@2", num_nodes=m)
        tr = _make_trainer(m=m, batches=2, outer_strategy="agwu",
                           faults=faults)
        _pin_durations(tr, np.ones(m))
        _drain(tr, 4)
        part = tr.dataset.part
        assert part.done and len(part.history) == 2
        first, second = part.history
        assert second[2] == 0
        assert part.totals[2] == first[2]
        b = part.num_samples // part.num_batches
        assert second.sum() == b


# ----------------------------------------------------------------------
# adversarial AGWU heaps
# ----------------------------------------------------------------------
# the reference's pinned Eq. 10 gamma traces (tests/test_chaos.py): they
# depend only on the heap order and the versions, which the port keeps
GAMMAS_STRAGGLER = [0.333333, 0.211942, 0.186324, 0.230237, 0.254275,
                    0.328933, 0.390166, 0.287004, 0.435954]
GAMMAS_CHURN = [0.333333, 0.211942, 0.186324, 0.230237, 0.326496,
                0.290461, 0.351311, 0.312736, 0.4055]


@pytest.fixture
def gamma_log(monkeypatch):
    """Record every Eq. 10 gamma the port's parameter server computes."""
    rec = []
    orig = param_server_module.agwu_gamma

    def wrapper(*a, **k):
        g = orig(*a, **k)
        rec.append(round(float(g), 6))
        return g

    monkeypatch.setattr(param_server_module, "agwu_gamma", wrapper)
    return rec


class TestAdversarialHeap:
    def test_duplicate_timestamps_order_by_node(self):
        m, rounds = 4, 3
        tr = _make_trainer(m=m, outer_strategy="agwu")
        _pin_durations(tr, np.ones(m))
        events = _drain(tr, rounds)
        assert len(events) == m * rounds
        assert [ev.node for ev in events] == list(range(m)) * rounds
        for j in range(m):
            clocks = [ev.virtual_clock for ev in events if ev.node == j]
            assert clocks == sorted(clocks)

    def test_straggler_pushes_arrive_after_everyone_finished(self,
                                                            gamma_log):
        m, rounds = 3, 3
        tr = _make_trainer(m=m, outer_strategy="agwu")
        _pin_durations(tr, np.array([1.0, 1.0, 50.0]))
        events = _drain(tr, rounds)
        assert len(events) == m * rounds
        assert [ev.node for ev in events[-2:]] == [2, 2]
        fast_done = max(i for i, ev in enumerate(events) if ev.node != 2)
        assert fast_done == m * rounds - 3
        assert len(gamma_log) == m * rounds
        straggler_gammas = [g for ev, g in zip(events, gamma_log, strict=True)
                            if ev.node == 2]
        assert min(gamma_log) == min(straggler_gammas)
        assert gamma_log == GAMMAS_STRAGGLER, \
            f"gamma trace drifted: {gamma_log}"

    def test_gamma_pinned_under_churn(self, gamma_log):
        m, rounds = 3, 3
        faults = FaultSchedule.from_spec("fail:1@2,rejoin:1@5", num_nodes=m)
        tr = _make_trainer(m=m, faults=faults, outer_strategy="agwu")
        _pin_durations(tr, np.array([1.0, 1.1, 1.2]))
        _drain(tr, rounds)
        assert gamma_log == GAMMAS_CHURN, \
            f"gamma trace drifted: {gamma_log}"

    def test_lost_push_never_reaches_server(self):
        m, rounds = 4, 3
        faults = FaultSchedule.from_spec("fail:3@2", num_nodes=m)
        tr = _make_trainer(m=m, faults=faults, outer_strategy="agwu")
        _pin_durations(tr, np.ones(m))
        events = _drain(tr, rounds)
        assert len(events) == (m - 1) * rounds
        assert all(ev.node != 3 for ev in events)
