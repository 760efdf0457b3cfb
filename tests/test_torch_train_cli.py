"""The port's training CLI (``repro_torch.launch.train``) against the
reference's (``repro.launch.train.main``) on the CPU, as
``tests/test_system.py``'s ``TestLMEndToEnd`` trains it: reduced Phi-3 on
2 nodes, and the reduced MoE family (Qwen3-MoE, Granite-MoE) the same
way, here in f32 (both packages' ``get_reduced`` patched to f32
activations) from the same numpy params, under AGWU (``heap``) and SGWU
(``vmap``).

The clock is pinned as ``tests/test_torch_outer.py`` pins it: each
package's ``core/engine`` module sees a stub ``time`` whose
``perf_counter`` steps by a fixed amount, and ``BPTTrainer._local_round``
reports a fixed duration per node.  Then allocations, the virtual clock,
the sync-wait and Eq. 11's comm bytes must be equal, the losses within
rtol 1e-4 / atol 1e-6 and the final weights within rtol 1e-3 / atol 1e-5
(the outer layer's tolerances).  At every local step of the port's run,
its gradient (every leaf) is also held against ``jax.grad`` of the
reference's loss at the same params and batch, within the f32 gradient
tolerance (atol 2e-5 / rtol 1e-4; seen within 3.3e-07).  In the
embedding and head tables at most 1e-3 of the final elements may stray,
within the learning rate: AdamW's normalised step divides an element's
gradient rounding error by the gradient itself, so elements with small
gradients drift apart over the steps (seen: 29 and 9 of 131072 after 16
SGWU node steps, at most 6.0e-04 off, while every step's gradients
agreed within 3.3e-07; one AGWU element whose gradient was at rounding
level in one step, 2.97e-07 of the table's largest, took AdamW's step of
the other sign).  The CLI's ``--ckpt-dir`` checkpoint restores in both
packages, and ``--ckpt-every`` / ``--resume`` run the reference's flows:
a finished command re-run trains nothing, a larger ``--rounds``
continues.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import repro.core.engine as jengine  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.checkpointing import checkpoint as jckpt  # noqa: E402
from repro.core.bpt_trainer import BPTTrainer as JTrainer  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
import repro_torch.core.engine as engine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpointing import checkpoint as ckpt  # noqa: E402
from repro_torch.core.bpt_trainer import BPTTrainer  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.weights import (params_from_numpy,  # noqa: E402
                                 params_to_numpy)

ARCH = "phi3-mini-3.8b"
# the MoE family, one outer strategy each (the CPU suite's time)
MOE_RUNS = (("qwen3-moe-30b-a3b", "agwu"), ("granite-moe-3b-a800m", "sgwu"))
LR = 3e-3
TABLES = ("['embed']['table']", "['lm_head']['table']")
ARGS = ["--nodes", "2", "--rounds", "4", "--rows", "64", "--seq-len", "32",
        "--batch-size", "8", "--lr", str(LR)]
TICK = 0.05


class _Clock:
    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += TICK
        return self.now


def _pin(monkeypatch, cls):
    orig = cls._local_round

    def pinned(self, params, opt_state, node, step):
        p, o, loss, _ = orig(self, params, opt_state, node, step)
        return p, o, loss, 0.01 * float(self.speed[node])
    monkeypatch.setattr(cls, "_local_round", pinned)


def _f32(get):
    return lambda name: dataclasses.replace(get(name), dtype="float32")


@pytest.fixture
def pinned(monkeypatch):
    monkeypatch.setenv("REPRO_COMPILATION_CACHE", "off")
    monkeypatch.setattr(jconfigs, "get_reduced",
                        _f32(jconfigs.get_reduced))
    for module in (jengine, engine):
        monkeypatch.setattr(module, "time", _Clock())
    _pin(monkeypatch, JTrainer)
    _pin(monkeypatch, BPTTrainer)


def _recording(monkeypatch):
    """Patches the port's ``lm.loss_fn`` to record the params and batch
    of every call that builds a gradient (the local steps)."""
    seen, loss_fn = [], lm.loss_fn

    def recording(params, batch, cfg, **kw):
        if torch.is_grad_enabled():
            seen.append((params_to_numpy(params),
                         {k: v.numpy().copy() for k, v in batch.items()}))
        return loss_fn(params, batch, cfg, **kw)
    monkeypatch.setattr(lm, "loss_fn", recording)
    return seen, loss_fn


@pytest.mark.parametrize("outer", ["agwu", "sgwu"])
def test_train_cli_matches_the_reference(pinned, monkeypatch, outer):
    _matches_the_reference(monkeypatch, ARCH, outer)


@pytest.mark.parametrize("arch,outer", MOE_RUNS)
def test_moe_train_cli_matches_the_reference(pinned, monkeypatch, arch,
                                             outer):
    """Qwen3-MoE (``qk_norm``) and Granite-MoE: the moe block's routing,
    aux and expert gradients through the outer layer."""
    _matches_the_reference(monkeypatch, arch, outer)


def _matches_the_reference(monkeypatch, arch, outer):
    argv = ["--arch", arch] + ARGS + ["--outer", outer]
    jrep = jtrain.main(argv)
    cfg = _f32(configs.get_reduced)(arch)
    jcfg = jconfigs.get_reduced(arch)            # f32, patched by `pinned`
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg, device="cpu")
    seen, loss_fn = _recording(monkeypatch)
    rep = train.run(train.make_parser().parse_args(argv + ["--device",
                                                           "cpu"]),
                    cfg, params)
    assert (rep.strategy, rep.backend) == (jrep.strategy, jrep.backend)
    assert rep.steps == jrep.steps and rep.last_event == jrep.last_event
    assert rep.virtual_makespan == jrep.virtual_makespan
    assert rep.sync_wait == jrep.sync_wait
    assert rep.comm_bytes == jrep.comm_bytes
    np.testing.assert_array_equal(rep.allocation, jrep.allocation)
    np.testing.assert_allclose(rep.losses, jrep.losses, rtol=1e-4,
                               atol=1e-6)
    assert rep.losses[-1] < rep.losses[0]
    # every local step's gradient against the reference's at its inputs
    assert len(seen) == 16                 # 4 rounds x 2 nodes x 2 steps
    jgrad = jax.jit(jax.grad(lambda p, b: jlm.loss_fn(p, b, jcfg)[0]))
    for p, batch in seen:
        want = jax.tree_util.tree_leaves(jgrad(p, batch))
        tp = params_from_numpy(p, cfg, device="cpu")
        leaves = [t.requires_grad_() for t in tree_leaves(tp)]
        loss, _ = loss_fn(tp, {k: torch.from_numpy(v)
                               for k, v in batch.items()}, cfg)
        for a, b in zip(torch.autograd.grad(loss, leaves), want,
                        strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=2e-5)
    for (path, b), a in zip(
            jax.tree_util.tree_flatten_with_path(jrep.final_params)[0],
            tree_leaves(rep.final_params), strict=True):
        a, b = a.numpy(), np.asarray(b)
        if jax.tree_util.keystr(path) in TABLES:
            off = np.abs(a - b) > 1e-5 + 1e-3 * np.abs(b)
            assert off.mean() <= 1e-3
            np.testing.assert_allclose(a, b, rtol=0, atol=LR)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5)


def test_cli_checkpoint_restores_in_both_packages(tmp_path, capsys):
    argv = ["--device", "cpu", "--rounds", "2", "--rows", "16",
            "--seq-len", "16", "--nodes", "2", "--ckpt-dir", str(tmp_path)]
    rep = train.main(argv)
    assert "[train] checkpoint:" in capsys.readouterr().out
    cfg = configs.get_reduced("yi-6b")
    like = lm.init_params(cfg, torch.Generator().manual_seed(1),
                          device="cpu")
    got, step = ckpt.restore(str(tmp_path), like)
    assert step == rep.last_event == 4     # AGWU: 2 rounds x 2 nodes
    for a, b in zip(tree_leaves(got), tree_leaves(rep.final_params),
                    strict=True):
        assert torch.equal(a, b)
    jlike = jlm.init_params(jax.random.PRNGKey(0),
                            jconfigs.get_reduced("yi-6b"))
    jgot, _ = jckpt.restore(str(tmp_path), jlike)
    for a, b in zip(tree_leaves(rep.final_params),
                    jax.tree_util.tree_leaves(jgot), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ckpt.load_manifest(str(tmp_path), 4)["metadata"] == {
        "arch": "yi-6b"}


@pytest.mark.parametrize("flags", [["--ckpt-every", "2"],
                                   ["--resume", "--ckpt-dir", "x"]],
                         ids=["every-without-dir", "resume-without-every"])
def test_snapshot_flags_need_their_partners(flags):
    """``--ckpt-every`` needs ``--ckpt-dir`` and ``--resume`` needs both,
    with the reference's messages."""
    with pytest.raises(SystemExit) as want:
        jtrain.main(["--rounds", "1"] + flags)
    with pytest.raises(SystemExit) as got:
        train.main(["--device", "cpu", "--rounds", "1"] + flags)
    assert str(got.value) == str(want.value) != ""


def _resume_flow(run_cli, ckdir, capsys):
    """The CLI with ``--ckpt-every 2 --resume``: a run of 2 rounds, the same
    command again, then 3 rounds.  Returns the three reports, what the
    second one printed and the directory's files after each run."""
    argv = ["--nodes", "2", "--rows", "32", "--seq-len", "16",
            "--batch-size", "4", "--ckpt-dir", str(ckdir), "--ckpt-every",
            "2", "--resume"]
    reps, files, out = [], [], ""
    for rounds in (2, 2, 3):
        capsys.readouterr()
        reps.append(run_cli(argv + ["--rounds", str(rounds)]))
        if len(reps) == 2:
            out = capsys.readouterr().out
        files.append(sorted(os.listdir(ckdir)))
    return reps, out, files


def test_cli_resume_flows_match_the_reference(pinned, tmp_path, capsys):
    """Re-running a finished command prints the reference's line and
    writes no stray checkpoint; a larger ``--rounds`` continues (the AGWU
    heap re-seeded); the final ``ckpt_*`` step is ``last_event`` — in the
    port as in the reference, event for event."""
    arch = "yi-6b"
    cfg = _f32(configs.get_reduced)(arch)
    jparams = jlm.init_params(jax.random.PRNGKey(0),
                              jconfigs.get_reduced(arch))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg, device="cpu")
    jreps, jout, jfiles = _resume_flow(jtrain.main, tmp_path / "jax",
                                       capsys)
    reps, out, files = _resume_flow(
        lambda argv: train.run(train.make_parser().parse_args(
            argv + ["--device", "cpu"]), cfg, params),
        tmp_path / "port", capsys)
    assert "resumed past the final round; no new rounds ran" in out
    assert "resumed past the final round; no new rounds ran" in jout
    assert files == jfiles
    assert files[0] == files[1]             # the re-run wrote nothing
    assert reps[1].losses == [] and reps[1].last_event == 0
    assert [r.last_event for r in reps] == [r.last_event for r in jreps] \
        == [4, 0, 6]
    assert reps[2].steps == 2               # events 4 and 5, re-seeded
    assert ckpt.latest_step(str(tmp_path / "port")) == reps[2].last_event
    assert ckpt.latest_step(str(tmp_path / "port"), kind="state") == 6
    for a, b in zip(reps, jreps):
        assert a.comm_bytes == b.comm_bytes
        assert a.virtual_makespan == b.virtual_makespan
        np.testing.assert_allclose(a.losses, b.losses, rtol=1e-4, atol=1e-6)
    got, _ = ckpt.restore(str(tmp_path / "port"), params)
    for a, b in zip(tree_leaves(got), tree_leaves(reps[2].final_params),
                    strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flags", [
    ["--outer", "sgwu", "--device-outer", "--mesh", "nodes4"],
    ["--engine", "device", "--mesh", "nodes4"],
    ["--engine", "heap-device"]], ids=["device-outer", "engine", "agwu"])
def test_mesh_request_on_the_cpu_falls_back_as_the_reference(flags,
                                                              capsys):
    """``--mesh nodes4`` on one CPU device: the run falls back to the
    fused node loop and prints the reference's fallback line (the
    reference on its one device); the AGWU device engine alike."""
    argv = ["--nodes", "4", "--rounds", "1", "--rows", "32", "--seq-len",
            "16", "--batch-size", "4"] + flags
    want = jtrain.main(argv)
    want_out = capsys.readouterr().out
    got = train.main(["--device", "cpu"] + argv)
    got_out = capsys.readouterr().out
    line = [ln for ln in want_out.splitlines()
            if ln.startswith("[train] engine fallback:")]
    assert line and line[0] in got_out.splitlines()
    assert (got.backend, got.fallback) == (want.backend, want.fallback)
    assert got.backend in ("vmap", "heap")
