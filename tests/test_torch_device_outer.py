"""The port's multi-device outer layer against the JAX package: the
counterpart of ``tests/test_device_outer.py`` and of the engine cases of
``tests/test_planner.py``.

The reference's multi-device tests need forced host devices and skip in
a one-device run; the port's pool is explicit, so here every node gets a
CPU "device" of its own (``[torch.device("cpu")] * n``) and the sharded
paths run in the tier-1 suite:

* ``ShardMapEngine`` (backend ``device``) at m = 2 and 8, even and
  uneven stripes, and on the 2-D meshes ``nodes2xmodel2`` and
  ``nodes4xmodel2`` under the batch and channel families (and the
  cost-picked and generic plans), each held to the JAX ``VmapEngine``
  trajectory and merged weights within rtol 1e-5 / atol 1e-6 (the
  reference's own bar between its device and vmap engines);
* the JAX ``ShardMapEngine`` itself on ``nodes2xmodel2`` (channel family),
  run in a subprocess with ``XLA_FLAGS=
  --xla_force_host_platform_device_count=4``, against the port's;
* scheduled == executed; Eq. 11 comm bytes unchanged; the sharded Eq. 7
  merge equal to the host merge; the server's ``mesh=`` mode equal to its
  host mode; the delta push equal to the full push;
* ``HeapDeviceEngine`` (``heap-device``) held to the JAX ``HeapEngine``
  with the per-node durations pinned;
* ``resolve_engine``'s fallbacks and bad-mesh errors with the
  reference's messages.

Batches=1 freezes the IDPA allocation, so both packages see the same data
whatever the wall time.  Trajectories run on one torch thread.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import repro.core.engine as jengine  # noqa: E402
from repro.core.bpt_trainer import BPTTrainer as JTrainer  # noqa: E402
from repro.core.gwu import sgwu_merge_stacked as jmerge  # noqa: E402
from repro.core.types import TrainConfig as JTrainConfig  # noqa: E402
from repro.data.pipeline import IDPADataset as JDataset  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.core import engine, planner  # noqa: E402
from repro_torch.core.bpt_trainer import BPTTrainer  # noqa: E402
from repro_torch.core.gwu import (sgwu_merge_and_rebroadcast_sharded,  # noqa: E402
                                  sgwu_merge_stacked, tree_sub)
from repro_torch.core.param_server import ParameterServer  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.core.types import TrainConfig  # noqa: E402
from repro_torch.data.pipeline import IDPADataset  # noqa: E402
from repro_torch.data.synthetic import image_dataset  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
EQUIV = dict(name="equiv", image_size=8, conv_layers=1, filters=4,
             fc_layers=1, fc_neurons=32)
RTOL, ATOL = 1e-5, 1e-6


def pool(n):
    return [CPU] * n


def _tc_kw(m, strategy="sgwu", local_steps=2, **kw):
    return dict(outer_strategy=strategy, outer_nodes=m, optimizer="adamw",
                learning_rate=2e-3, total_steps=100, warmup_steps=5,
                local_steps=local_steps, seed=0, **kw)


def _data(m, hetero):
    xs, ys = image_dataset(64 * m * 2, size=8, seed=0)
    freqs = np.linspace(1.0, 2.0, m) if hetero else None
    return xs, ys, freqs


def _jax_tree():
    return jax.tree_util.tree_map(np.asarray, jcnn.init_cnn(
        jax.random.PRNGKey(0), jcnn.CNNConfig(**EQUIV)))


def _port(m, *, mesh_name="", family="", uneven=False, hetero=False,
          devices=None, model_cfg=True, device=True, batch_size=32,
          strategy="sgwu", local_steps=2):
    """A port trainer on the equivalence config from the reference's
    numpy params, its pool ``devices`` (default one CPU per node and
    model shard)."""
    cfg = cnn.CNNConfig(**EQUIV)
    xs, ys, freqs = _data(m, hetero)
    ds = IDPADataset({"images": xs, "labels": ys}, num_nodes=m, batches=1,
                     frequencies=freqs)
    tc = TrainConfig(**_tc_kw(m, strategy, local_steps, device_outer=device,
                              uneven_batches=uneven, mesh_name=mesh_name))
    return BPTTrainer(lambda p, b: (cnn.cnn_loss(p, b, cfg), {}),
                      weights.params_from_numpy(_jax_tree(), cfg, "cpu"),
                      ds, tc, batch_size=batch_size,
                      model_cfg=cfg if model_cfg else None,
                      plan_family=family,
                      devices=pool(2 * m) if devices is None else devices)


def _jax(m, *, uneven=False, hetero=False, batch_size=32, strategy="sgwu",
         local_steps=2):
    """The JAX trainer on its one device: ``vmap`` (SGWU) or ``heap``."""
    cfg = jcnn.CNNConfig(**EQUIV)
    xs, ys, freqs = _data(m, hetero)
    ds = JDataset({"images": xs, "labels": ys}, num_nodes=m, batches=1,
                  frequencies=freqs)
    tc = JTrainConfig(**_tc_kw(m, strategy, local_steps, device_outer=False,
                               uneven_batches=uneven, fused_outer=True))
    return JTrainer(lambda p, b: (jcnn.cnn_loss(p, b, cfg), {}),
                    jax.tree_util.tree_map(jnp.asarray, _jax_tree()), ds, tc,
                    batch_size=batch_size)


_JAX_RUNS: dict = {}


def _jax_vmap(m, rounds, uneven=False, hetero=False):
    key = (m, rounds, uneven, hetero)
    if key not in _JAX_RUNS:
        rep = _jax(m, uneven=uneven, hetero=hetero).train(rounds)
        assert rep.backend == "vmap"
        _JAX_RUNS[key] = (list(rep.losses), rep.comm_bytes, [
            np.asarray(x) for x in jax.tree_util.tree_leaves(
                rep.final_params)])
    return _JAX_RUNS[key]


def _assert_held(rep, want, rtol=RTOL, atol=ATOL):
    losses, comm, leaves = want
    np.testing.assert_allclose(rep.losses, losses, rtol=rtol, atol=atol)
    got = [x.numpy() for x in tree_leaves(rep.final_params)]
    assert len(got) == len(leaves)
    for a, b in zip(got, leaves, strict=True):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    assert rep.comm_bytes == comm


# ----------------------------------------------------------------------
# the sharded engines against the JAX package
# ----------------------------------------------------------------------
@pytest.mark.parametrize("m,rounds", [(2, 3), (8, 4)])
@pytest.mark.parametrize("uneven", [False, True])
def test_shardmap_1d_matches_the_jax_vmap_engine(m, rounds, uneven):
    tr = _port(m, uneven=uneven, hetero=uneven)
    rep = tr.train(rounds)
    assert rep.backend == "device" and not rep.fallback
    assert tr.last_engine.netplan is None
    assert tr.last_plan.mesh.shape == {"nodes": m}
    _assert_held(rep, _jax_vmap(m, rounds, uneven, uneven))


@pytest.mark.parametrize("mesh_name", ["nodes2xmodel2", "nodes4xmodel2"])
@pytest.mark.parametrize("family", ["batch", "channel", ""])
def test_hybrid_mesh_matches_the_jax_vmap_engine(mesh_name, family):
    m = int(mesh_name[5])
    tr = _port(m, mesh_name=mesh_name, family=family)
    rep = tr.train(3)
    eng = tr.last_engine
    assert rep.backend == "device"
    assert eng.netplan.family == (family or eng.netplan.family)
    assert eng.netplan.model == 2
    _assert_held(rep, _jax_vmap(m, 3))


def test_hybrid_uneven_masked_stripes():
    """Masked stripes recombine exactly: the gradient of Σlm/Σm is
    Σ(M_s·g_s)/ΣM_s, which grad_combine implements."""
    rep = _port(4, mesh_name="nodes4xmodel2", family="batch", uneven=True,
                hetero=True).train(3)
    _assert_held(rep, _jax_vmap(4, 3, True, True))


def test_generic_plan_without_model_cfg():
    tr = _port(2, mesh_name="nodes2xmodel2", model_cfg=False)
    rep = tr.train(3)
    assert tr.last_engine.netplan.family == "batch"
    assert tr.last_engine.netplan.layers == ()
    assert tr.last_engine.executed == []
    _assert_held(rep, _jax_vmap(2, 3))


@pytest.mark.parametrize("family", ["batch", "channel"])
def test_scheduled_equals_executed(family):
    """The NetworkPlan the planner emits is what the round ran: the
    engine's plan is ``plan_for_axes``'s, and the ops consumed its conv
    and fc LayerPlans in forward order (pools take no plan), once."""
    tr = _port(2, mesh_name="nodes2xmodel2", family=family)
    tr.train(2)
    eng = tr.last_engine
    want = planner.plan_for_axes(cnn.CNNConfig(**EQUIV), nodes=2, model=2,
                                 batch_size=32, family=family)
    assert eng.netplan == want
    planned = [lp for lp in eng.netplan.layers if lp.kind != "pool"]
    assert eng.executed == planned
    batch_spec = ("nodes", None, "model") if family == "batch" \
        else ("nodes",)
    assert eng.netplan.batch_spec == batch_spec


def test_comm_bytes_and_server_placement():
    """Eq. 11 comm equal to the vmap engine's; the merged weights on the
    server's device, node j's optimizer state on node j's."""
    tr = _port(2)
    rep = tr.train(2)
    vm = _port(2, device=False).train(2)
    assert rep.comm_bytes == vm.comm_bytes
    st = tr.last_engine.setup(1)
    assert isinstance(st.stacked_opt, list) and len(st.stacked_opt) == 2
    assert st.server.mesh is tr.last_plan.mesh
    for leaf in tree_leaves(rep.final_params):
        assert leaf.device == CPU


def test_jax_shardmap_engine_on_a_forced_four_device_host(tmp_path):
    """The reference's own ShardMapEngine on ``nodes2xmodel2`` (channel
    family) under four forced host devices, in a subprocess; the port's
    run on a 4-CPU pool is held to its losses and merged weights."""
    out = tmp_path / "jax_shardmap.npz"
    code = textwrap.dedent(f"""
        import sys
        import jax, jax.numpy as jnp, numpy as np
        sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO / 'tests')!r}]
        from test_torch_device_outer import _jax_tree, _tc_kw, _data, EQUIV
        from repro.core.bpt_trainer import BPTTrainer
        from repro.core.types import TrainConfig
        from repro.data.pipeline import IDPADataset
        from repro.models import cnn as jcnn
        assert len(jax.devices()) == 4
        cfg = jcnn.CNNConfig(**EQUIV)
        xs, ys, _ = _data(2, False)
        ds = IDPADataset({{"images": xs, "labels": ys}}, num_nodes=2,
                         batches=1)
        tc = TrainConfig(**_tc_kw(2, device_outer=True,
                                  mesh_name="nodes2xmodel2"))
        tr = BPTTrainer(lambda p, b: (jcnn.cnn_loss(p, b, cfg), {{}}),
                        jax.tree_util.tree_map(jnp.asarray, _jax_tree()),
                        ds, tc, batch_size=32, model_cfg=cfg,
                        plan_family="channel")
        rep = tr.train(3)
        assert rep.backend == "device", rep.backend
        leaves = [np.asarray(x) for x in
                  jax.tree_util.tree_leaves(rep.final_params)]
        np.savez({str(out)!r}, losses=np.asarray(rep.losses),
                 comm=np.asarray(rep.comm_bytes),
                 family=np.asarray(tr.last_engine.netplan.family),
                 **{{f"leaf{{i}}": x for i, x in enumerate(leaves)}})
    """)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = np.load(out)
    assert str(ref["family"]) == "channel"
    n = len([k for k in ref.files if k.startswith("leaf")])
    want = (list(ref["losses"]), int(ref["comm"]),
            [ref[f"leaf{i}"] for i in range(n)])
    rep = _port(2, mesh_name="nodes2xmodel2", family="channel",
                devices=pool(4)).train(3)
    _assert_held(rep, want)


# ----------------------------------------------------------------------
# the sharded Eq. 7 merge and the device-resident server
# ----------------------------------------------------------------------
def _stacked(m, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return {"w": np.asarray(jax.random.normal(ks[0], (m, 4, 3))),
            "b": {"x": np.asarray(jax.random.normal(ks[1], (m, 5))),
                  "s": np.asarray(jax.random.normal(ks[2], (m,)))}}


def _node_list(stacked, m):
    return [tree_map(lambda x: torch.from_numpy(np.array(x[j])), stacked)
            for j in range(m)]


@pytest.mark.parametrize("m", [2, 8])
def test_sharded_merge_matches_the_host_merge(m):
    mesh = pmesh.make_nodes_mesh(m, devices=pool(m))
    qs = list(np.linspace(0.2, 1.0, m))
    host = _stacked(m)
    want = jmerge(jax.tree_util.tree_map(jnp.asarray, host), qs)
    port_host = sgwu_merge_stacked(
        tree_map(lambda x: torch.from_numpy(np.array(x)), host), qs)
    nodes = _node_list(host, m)
    merged, again = sgwu_merge_and_rebroadcast_sharded(nodes, qs, mesh)
    assert again is nodes
    for a, b, c in zip(tree_leaves(merged), jax.tree_util.tree_leaves(want),
                       tree_leaves(port_host), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
        assert torch.equal(a, c)     # the same ops as the stacked merge
    # every node's tree now holds the merged weights
    for tree in again:
        for leaf, mg in zip(tree_leaves(tree), tree_leaves(merged),
                            strict=True):
            assert torch.equal(leaf, mg)
    with pytest.raises(ValueError, match="do not divide"):
        sgwu_merge_and_rebroadcast_sharded(
            _node_list(_stacked(3), 3), [1.0] * 3,
            pmesh.make_nodes_mesh(2, devices=pool(2)))


def test_server_mesh_mode_matches_host_mode():
    mesh = pmesh.make_nodes_mesh(2, devices=pool(2))
    qs = [0.3, 0.7]
    init = _node_list(_stacked(1), 1)[0]["b"]
    host = ParameterServer(init, num_workers=2)
    dev = ParameterServer(init, num_workers=2, mesh=mesh)
    stacked, _ = dev.pull_all_stacked()
    assert isinstance(stacked, list) and len(stacked) == 2
    for tree in stacked:       # replicas in buffers of their own
        for a, b in zip(tree_leaves(tree), tree_leaves(init), strict=True):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    host.pull_all_stacked()
    sub = [_node_list(_stacked(1, seed=s), 1)[0]["b"] for s in (1, 2)]
    host.push_sgwu_stacked(tree_map(lambda *xs: torch.stack(xs), *sub), qs)
    dev.push_sgwu_stacked([tree_map(torch.clone, t) for t in sub], qs)
    for a, b in zip(tree_leaves(host.global_weights),
                    tree_leaves(dev.global_weights), strict=True):
        assert torch.equal(a, b)
    assert host.comm_bytes == dev.comm_bytes
    assert host.version == dev.version == 1
    again, version = dev.pull_all_stacked()     # the rebroadcast cache
    assert version == 1
    for tree in again:
        for leaf, mg in zip(tree_leaves(tree),
                            tree_leaves(dev.global_weights), strict=True):
            assert torch.equal(leaf, mg)


@pytest.mark.parametrize("mesh_name,workers,err", [
    ("tiny", 2, "device-resident mode needs a `nodes` axis"),
    ("nodes4", 6, "6 workers do not divide the `nodes` axis (4)")])
def test_server_mesh_checks(mesh_name, workers, err):
    mesh = pmesh.make_mesh(mesh_name, devices=pool(4))
    with pytest.raises(ValueError) as got:
        ParameterServer({"a": torch.zeros(2)}, workers, mesh=mesh)
    assert str(got.value) == err


def test_delta_push_matches_full_push():
    """push_agwu_delta(W_j - W(k)) ≡ push_agwu(W_j): the same math split
    at the subtraction, the same bookkeeping."""
    def tree(v):
        return {"a": torch.full((3, 2), v), "b": torch.full((4,), 2 * v)}
    full = ParameterServer(tree(0.5), num_workers=2)
    delta = ParameterServer(tree(0.5), num_workers=2)
    for ps in (full, delta):
        for j in range(2):
            ps.pull(j)
    full.push_agwu(0, tree(1.5), 0.7, virtual_time=1.0)
    delta.push_agwu_delta(0, tree_sub(tree(1.5), tree(0.5)), 0.7,
                          virtual_time=1.0)
    for a, b in zip(tree_leaves(full.global_weights),
                    tree_leaves(delta.global_weights), strict=True):
        assert torch.equal(a, b)
    assert full.comm_bytes == delta.comm_bytes
    assert full.version == delta.version
    assert [s.base_version for s in full.update_log] == \
        [s.base_version for s in delta.update_log]
    fresh = ParameterServer(tree(0.0), num_workers=1)
    with pytest.raises(RuntimeError, match="never pulled"):
        fresh.push_agwu_delta(0, tree(0.1), 1.0)


# ----------------------------------------------------------------------
# AGWU with node-pinned weights
# ----------------------------------------------------------------------
def _pin(tr, durs):
    orig = tr._local_round

    def pinned(params, opt_state, node, step):
        p, o, loss, _ = orig(params, opt_state, node, step)
        return p, o, loss, float(durs[node])

    tr._local_round = pinned


@pytest.mark.parametrize("m", [2, 4])
def test_heap_device_matches_the_jax_heap_engine(m):
    durs = 1.0 + 0.3 * np.arange(m)
    tr = _port(m, strategy="agwu", batch_size=16, local_steps=1)
    jtr = _jax(m, strategy="agwu", batch_size=16, local_steps=1)
    _pin(tr, durs)
    _pin(jtr, durs)
    port, ref = list(tr.run(3)), list(jtr.run(3))
    assert tr.last_plan.backend == "heap-device"
    assert jtr.last_plan.backend == "heap"
    assert [e.node for e in port] == [e.node for e in ref]
    assert [e.virtual_clock for e in port] == [e.virtual_clock for e in ref]
    assert [e.comm_bytes for e in port] == [e.comm_bytes for e in ref]
    np.testing.assert_allclose([e.loss for e in port],
                               [e.loss for e in ref], rtol=RTOL, atol=ATOL)
    for a, b in zip(tree_leaves(port[-1].params),
                    jax.tree_util.tree_leaves(ref[-1].params), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


# ----------------------------------------------------------------------
# resolve_engine: the reference's rules and messages
# ----------------------------------------------------------------------
def _resolve(cfg, devices):
    try:
        p = engine.resolve_engine(cfg, devices)
    except ValueError as e:
        return "ValueError", str(e)
    return p.backend, p.requested, p.fallback


@pytest.mark.parametrize("strategy,want", [("sgwu", "device"),
                                           ("agwu", "heap-device")])
@pytest.mark.parametrize("m", [1, 2, 8])
def test_resolve_with_enough_devices(strategy, want, m):
    plan = engine.resolve_engine(TrainConfig(
        outer_strategy=strategy, device_outer=True, outer_nodes=m), pool(m))
    assert (plan.backend, plan.requested, plan.fallback) == (want, want, "")
    assert plan.engine_cls is engine.ENGINES[want]
    if want == "device":
        assert plan.mesh.shape == {"nodes": m}
    else:
        assert plan.devices == pool(m)


@pytest.mark.parametrize("strategy", ["sgwu", "agwu"])
@pytest.mark.parametrize("mesh_name", ["", "nodes4", "nodes2xmodel2"])
def test_resolve_fallbacks_carry_the_reference_message(strategy, mesh_name):
    """Too few devices: the port's message is the reference's, read
    from the reference's resolve_engine on its one device."""
    m = 4 if mesh_name == "nodes4" else 2
    kw = dict(outer_strategy=strategy, device_outer=True, outer_nodes=m,
              mesh_name=mesh_name)
    got = _resolve(TrainConfig(**kw), pool(1))
    want = jengine.resolve_engine(JTrainConfig(**kw), jax.devices()[:1])
    assert got == (want.backend, want.requested, want.fallback)
    assert got[2]


@pytest.mark.parametrize("mesh_name,m,want", [
    ("tiny", 2, "mesh 'tiny' needs a `nodes` axis of size 2, has axes "
                "{'data': 2, 'model': 2}"),
    ("nodes4", 2, "mesh 'nodes4' needs a `nodes` axis of size 2, has axes "
                  "{'nodes': 4}"),
    ("nodes2xmodel4", 4, "mesh 'nodes2xmodel4' needs a `nodes` axis of "
                         "size 4, has axes {'nodes': 2, 'model': 4}")])
def test_resolve_bad_mesh_raises_the_reference_message(mesh_name, m, want):
    """The reference's message (``src/repro/core/engine.py:143-145``); its
    own run needs the forced devices, so the text is written out here."""
    got = _resolve(TrainConfig(outer_strategy="sgwu", device_outer=True,
                               outer_nodes=m, mesh_name=mesh_name), pool(8))
    assert got == ("ValueError", want)
