"""The port's runtime sanitizer (``repro_torch.sanitize``), from
``tests/test_sanitize.py``: the ``REPRO_SANITIZE`` gate, the sanctioned
escape hatch and its audit log (labels, order, nesting), compile budgets
over ``kernels/build.py``'s builds, and the engines' sanctioned syncs.

On the CPU ``sanitized`` arms nothing (a CPU tensor never syncs with a
card), so the sync guard itself is tested only on the card: the ``cuda``
cases skip here, in their body.  This file imports no JAX at module
level, so those cases run on a machine without it
(``python -m pytest --noconftest -m cuda tests/test_torch_sanitize.py``);
the one comparison with the reference's labels imports it in its body.
"""
import stat

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.sanitize import (CompileBudgetExceeded,  # noqa: E402
                                  clear_sync_log, compile_budget,
                                  compile_counts, sanctioned_scope,
                                  sanctioned_sync, sanitize_enabled,
                                  sanitized, sync_log)


@pytest.fixture
def sanitize_on(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    clear_sync_log()
    yield
    clear_sync_log()


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: on the CPU the sync guard arms "
                    "nothing")


# ----------------------------------------------------------------------
# gating
# ----------------------------------------------------------------------
class TestGating:
    @pytest.mark.parametrize("val,on", [
        ("1", True), ("on", True), ("yes", True),
        ("", False), ("0", False), ("off", False), ("OFF", False),
    ])
    def test_env_values(self, monkeypatch, val, on):
        monkeypatch.setenv("REPRO_SANITIZE", val)
        assert sanitize_enabled() is on

    def test_unset_is_off(self, monkeypatch):
        monkeypatch.delenv("REPRO_SANITIZE", raising=False)
        assert not sanitize_enabled()

    def test_sanitized_is_noop_on_the_cpu(self, sanitize_on):
        with sanitized("cpu"):
            x = torch.ones(3) * 2
            assert x.sum().item() == 6.0      # a CPU read never syncs
        assert sync_log() == []


# ----------------------------------------------------------------------
# the sanctioned escape hatch and its log
# ----------------------------------------------------------------------
class TestSanctioned:
    def test_scope_logs_its_label_when_it_ends(self, sanitize_on):
        with sanitized("round"):
            with sanctioned_scope("deliberate-upload"):
                assert sync_log() == []
        assert sync_log() == ["deliberate-upload"]

    def test_nested_scopes_log_inner_first(self, sanitize_on):
        with sanctioned_scope("outer"):
            with sanctioned_scope("inner"):
                pass
            sanctioned_sync(torch.ones(1), "sync")
        assert sync_log() == ["inner", "sync", "outer"]

    def test_sanctioned_sync_returns_numpy_and_logs(self, sanitize_on):
        x = {"a": torch.arange(3.0), "b": [torch.ones(2, 2)]}
        with sanitized("test"):
            out = sanctioned_sync(x, "round.losses")
        assert isinstance(out["a"], np.ndarray)
        assert isinstance(out["b"][0], np.ndarray)
        np.testing.assert_array_equal(out["a"], [0.0, 1.0, 2.0])
        assert sync_log() == ["round.losses"]

    def test_a_failed_scope_logs_nothing(self, sanitize_on):
        with pytest.raises(ValueError):
            with sanctioned_scope("boom"):
                raise ValueError("inside")
        assert sync_log() == []

    def test_sanctioned_sync_works_with_gate_off(self, monkeypatch):
        monkeypatch.setenv("REPRO_SANITIZE", "0")
        clear_sync_log()
        out = sanctioned_sync(torch.ones(3), "plain")
        assert isinstance(out, np.ndarray)
        assert sync_log() == ["plain"]
        clear_sync_log()


# ----------------------------------------------------------------------
# compile budgets: kernels/build.py's nvcc runs
# ----------------------------------------------------------------------
@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in ``nvcc`` that writes an empty file at ``-o``, and a
    build directory of the test's own, so ``build.build`` really runs
    (and counts) a compile here."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    ': > "$2"\necho "fake ptxas info"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_LOGS", {})
    return nvcc


class TestCompileBudget:
    def test_a_build_busts_a_zero_budget(self, fake_nvcc):
        with pytest.raises(CompileBudgetExceeded, match="budget 0"):
            with compile_budget(0, label="cold path"):
                build.build(["pool2d"])

    def test_a_built_library_meets_a_zero_budget(self, fake_nvcc):
        build.build(["pool2d", "conv2d"])               # the warm-up
        with compile_budget(0, label="steady state"):
            for _ in range(3):
                build.build(["pool2d", "conv2d"])

    def test_nonzero_budget_allows_bounded_builds(self, fake_nvcc):
        with compile_budget(2, label="two sources"):
            build.build(["pool2d", "rmsnorm"])

    def test_counter_counts_each_nvcc_run(self, fake_nvcc):
        before = compile_counts()
        build.build(["dense_fwd"])
        build.build(["dense_fwd"])             # built: no second run
        assert compile_counts() == {"compiles": before["compiles"] + 1}
        assert build.build_log("dense_fwd").strip() == "fake ptxas info"

    def test_a_cpu_round_compiles_nothing(self):
        """The CPU path runs the plain versions: no kernel builds."""
        tr = _trainer("sgwu", fused_outer=True)
        with compile_budget(0, label="cpu rounds"):
            tr.train(rounds=2)


# ----------------------------------------------------------------------
# the engines' sanctioned syncs
# ----------------------------------------------------------------------
def _trainer(strategy, m=2, eval_fn=False, **tc_kwargs):
    from repro_torch.core.bpt_trainer import BPTTrainer
    from repro_torch.core.types import TrainConfig
    from repro_torch.data.pipeline import IDPADataset
    from repro_torch.data.synthetic import image_dataset
    from repro_torch.models.cnn import (CNNConfig, cnn_accuracy, cnn_loss,
                                        init_cnn)
    cfg = CNNConfig(name="san", image_size=8, conv_layers=1, filters=4,
                    fc_layers=1, fc_neurons=32)
    xs, ys = image_dataset(64 * m * 2, size=8, seed=0)
    params = init_cnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    ds = IDPADataset({"images": xs, "labels": ys}, num_nodes=m, batches=1)
    tc = TrainConfig(outer_strategy=strategy, outer_nodes=m,
                     optimizer="adamw", learning_rate=2e-3,
                     total_steps=100, warmup_steps=5, local_steps=2,
                     seed=0, **tc_kwargs)
    ef = None
    if eval_fn:
        xe, ye = image_dataset(32, size=8, seed=9)
        eb = {"images": torch.from_numpy(xe), "labels": torch.from_numpy(ye)}

        def ef(p):
            return cnn_accuracy(p, eb, cfg)
    return BPTTrainer(lambda p, b: (cnn_loss(p, b, cfg), {}), params, ds,
                      tc, batch_size=16, eval_fn=ef)


# per event, with local_steps 2 and m 2: each batch placement is one
# "upload" (the port's label beyond the reference's), then the reference's
# labels in its order
EVENT_LABELS = {
    "scan": ["upload", "scan.loss"],
    "vmap": ["upload", "round.losses"],
    "sequential": ["upload", "upload", "local-round.loss"] * 2,
    "heap": ["upload", "upload", "local-round.loss"],
}
ENGINE_KW = {"scan": dict(strategy="sync"),
             "vmap": dict(strategy="sgwu", fused_outer=True),
             "sequential": dict(strategy="sgwu", fused_outer=False),
             "heap": dict(strategy="agwu")}


class TestEngineSyncs:
    @pytest.mark.parametrize("name", list(ENGINE_KW))
    def test_labels_and_order(self, sanitize_on, name):
        kw = dict(ENGINE_KW[name])
        rep = _trainer(kw.pop("strategy"), **kw).train(rounds=2)
        assert rep.backend == name
        assert sync_log() == EVENT_LABELS[name] * len(rep.losses)

    @pytest.mark.parametrize("strategy", ["sgwu", "agwu"])
    def test_evals_are_sanctioned(self, sanitize_on, strategy):
        rep = _trainer(strategy, eval_fn=True).train(rounds=2)
        assert all(np.isfinite(loss) for loss in rep.losses)
        labels = sync_log()
        assert set(labels) <= {"upload", "eval", "round.losses",
                               "local-round.loss"}
        assert labels.count("eval") >= len(rep.losses)

    @pytest.mark.parametrize("name", ["scan", "vmap", "sequential", "heap"])
    def test_labels_are_the_references_plus_uploads(self, sanitize_on,
                                                    name):
        """With the uploads left out, the port logs the reference's labels
        in the reference's order."""
        pytest.importorskip("jax")
        from repro.core.bpt_trainer import BPTTrainer as JTrainer
        from repro.core.types import TrainConfig as JTrainConfig
        from repro.data.pipeline import IDPADataset as JDataset
        from repro.data.synthetic import image_dataset
        from repro.models.cnn import CNNConfig, cnn_loss, init_cnn
        from repro.sanitize import clear_sync_log as jclear
        from repro.sanitize import sync_log as jlog
        import jax

        kw = dict(ENGINE_KW[name])
        strategy = kw.pop("strategy")
        rep = _trainer(strategy, **kw).train(rounds=2)
        cfg = CNNConfig(name="san", image_size=8, conv_layers=1, filters=4,
                        fc_layers=1, fc_neurons=32)
        xs, ys = image_dataset(256, size=8, seed=0)
        jtr = JTrainer(lambda p, b: (cnn_loss(p, b, cfg), {}),
                       init_cnn(jax.random.PRNGKey(0), cfg),
                       JDataset({"images": xs, "labels": ys}, num_nodes=2,
                                batches=1),
                       JTrainConfig(outer_strategy=strategy, outer_nodes=2,
                                    local_steps=2, **kw), batch_size=16)
        jclear()
        jrep = jtr.train(rounds=2)
        want = jlog()
        jclear()
        assert len(rep.losses) == len(jrep.losses)
        assert [x for x in sync_log() if x != "upload"] == want


# ----------------------------------------------------------------------
# on the card: the guard raises on a hidden sync
# ----------------------------------------------------------------------
@pytest.mark.cuda
def test_implicit_item_raises_inside_sanitized(sanitize_on):
    _need_card()
    x = torch.ones(4, device="cuda")
    before = torch.cuda.get_sync_debug_mode()
    with pytest.raises(RuntimeError, match="synchroniz"):
        with sanitized("test"):
            (x * 2).sum().item()
    assert torch.cuda.get_sync_debug_mode() == before


@pytest.mark.cuda
def test_sanctioned_item_does_not_raise(sanitize_on):
    _need_card()
    x = torch.ones(4, device="cuda")
    with sanitized("test"):
        y = x * 2                             # a launch is no sync
        with sanctioned_scope("read"):
            total = y.sum().item()
        host = sanctioned_sync(y, "pull")
        up = None
        with sanctioned_scope("upload"):
            up = torch.from_numpy(np.ones(3, np.float32)).to("cuda")
    assert total == 8.0 and host.tolist() == [2.0] * 4
    assert up.device.type == "cuda"
    assert sync_log() == ["read", "pull", "upload"]


@pytest.mark.cuda
def test_blocking_upload_raises_inside_sanitized(sanitize_on):
    _need_card()
    with pytest.raises(RuntimeError, match="synchroniz"):
        with sanitized("test"):
            torch.from_numpy(np.ones(3, np.float32)).to("cuda")
