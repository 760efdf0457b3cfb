"""The port's Eq. 7 / Eq. 9-10 merges (``core/gwu.py``) and its
``ParameterServer`` against the reference's, from the same numpy trees:
merges and updates at rtol 1e-6, ``agwu_gamma`` equal, and the server's
bookkeeping equal along a scripted pull/push sequence.  Two aliasing
tests hold what JAX's immutable arrays give the reference for free."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import gwu as jgwu  # noqa: E402
from repro.core.param_server import ParameterServer as JServer  # noqa: E402
from repro_torch.core import gwu  # noqa: E402
from repro_torch.core.param_server import ParameterServer  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

CPU = torch.device("cpu")


def _np_tree(rng, lead=()):
    return {"conv": [{"w": rng.standard_normal(lead + (3, 3, 2, 4)),
                      "b": rng.standard_normal(lead + (4,))}],
            "fc": [{"w": rng.standard_normal(lead + (8, 5)),
                    "b": rng.standard_normal(lead + (5,))}]}


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(port, ref, rtol=1e-6, atol=0.0):
    a, b = jax.tree_util.tree_leaves(ref), tree_leaves(port)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert y.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=rtol,
                                   atol=atol)


ACCS = {"uniform": [1.0, 1.0, 1.0, 1.0], "skewed": [0.91, 0.37, 0.52, 0.05],
        "zero": [0.0, 0.0, 0.0, 0.0], "one_dead": [0.6, 0.0, 0.8, 0.7]}


@pytest.mark.parametrize("accs", sorted(ACCS))
def test_eq7_merges_match_the_reference(accs):
    qs = ACCS[accs]
    rng = np.random.default_rng(0)
    trees = [_f32(_np_tree(rng)) for _ in qs]
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)
    _close(gwu.sgwu_merge([_t(x) for x in trees], qs),
           jgwu.sgwu_merge([_j(x) for x in trees], qs))
    _close(gwu.sgwu_merge_stacked(_t(stacked), qs),
           jgwu.sgwu_merge_stacked(_j(stacked), qs))
    merged, new = gwu.sgwu_merge_and_rebroadcast(_t(stacked), qs)
    jmerged, jnew = jgwu.sgwu_merge_and_rebroadcast(_j(stacked), qs)
    _close(merged, jmerged)
    _close(new, jnew)


def test_eq7_merge_checks_its_inputs():
    rng = np.random.default_rng(1)
    stacked = _t(_f32(_np_tree(rng, (3,))))
    with pytest.raises(ValueError, match="leading axis 3 != 2"):
        gwu.sgwu_merge_stacked(stacked, [0.5, 0.5])
    with pytest.raises(ValueError, match="at least one"):
        gwu.sgwu_merge([], [])
    with pytest.raises(ValueError, match="one accuracy"):
        gwu.sgwu_merge([stacked], [0.5, 0.5])


def test_broadcast_tree_matches_and_owns_its_buffers():
    tree = _f32(_np_tree(np.random.default_rng(2)))
    out = gwu.broadcast_tree(_t(tree), 3)
    _close(out, jgwu.broadcast_tree(_j(tree), num_nodes=3), rtol=0)
    for leaf in tree_leaves(out):
        assert leaf.stride(0) == leaf[0].numel()      # not a stride-0 view


@pytest.mark.parametrize("k,latest,outstanding", [
    (0, 0, []), (5, 6, []), (9, 10, [2]), (2, 10, [9]), (3, 3, [0, 1, 2]),
    (17, 21, [4, 20, 0, 13, 17]), (0, 1, [0, 0, 0])])
def test_agwu_gamma_equals_the_reference(k, latest, outstanding):
    assert gwu.agwu_gamma(k, latest, outstanding) == \
        jgwu.agwu_gamma(k, latest, outstanding)


@pytest.mark.parametrize("gamma,acc", [(0.5, 0.8), (1.0, 1.0),
                                       (0.2718, 1.73), (0.031, 0.25)])
def test_agwu_update_matches_the_reference(gamma, acc):
    rng = np.random.default_rng(3)
    g, lw, b = (_f32(_np_tree(rng)) for _ in range(3))
    _close(gwu.agwu_update(_t(g), _t(lw), _t(b), gamma, acc),
           jgwu.agwu_update(_j(g), _j(lw), _j(b), gamma, acc))
    delta = gwu.tree_sub(_t(lw), _t(b))
    _close(delta, jgwu.tree_sub(_j(lw), _j(b)), rtol=0)
    _close(gwu.agwu_update_delta(_t(g), delta, gamma, acc),
           jgwu.agwu_update_delta(_j(g), jgwu.tree_sub(_j(lw), _j(b)),
                                  gamma, acc))
    _close(gwu.tree_add_scaled(_t(g), _t(lw), 0.375),
           jgwu.tree_add_scaled(_j(g), _j(lw), 0.375))


def _script(server_cls, conv, pushes):
    """A scripted sequence of pulls and pushes; returns what the server
    reports along it (gammas, versions, comm bytes, state dict)."""
    rng = np.random.default_rng(4)
    w0 = _f32(_np_tree(rng))
    ps = server_cls(conv(w0), num_workers=3)
    out = [ps.weight_bytes, ps.expected_comm_bytes(5)]
    for j in range(3):
        ps.pull(j)
    for step, (kind, j, q) in enumerate(pushes):
        w = conv(_f32(_np_tree(rng)))
        if kind == "agwu":
            out.append(ps.push_agwu(j, w, q, virtual_time=0.5 * step))
            ps.pull(j)
        elif kind == "delta":
            out.append(ps.push_agwu_delta(j, w, q, virtual_time=0.5 * step))
            ps.pull(j)
        elif kind == "stacked":
            st, v = ps.pull_all_stacked(active=[True, j != 1, True])
            accs = [0.7, 0.4 if j != 1 else 0.0, 0.9]
            ps.push_sgwu_stacked(st, accs, virtual_time=0.5 * step,
                                 active=[True, j != 1, True])
            out.append(v)
        else:
            subs = [(i, None if i == j else w, 0.5 + 0.1 * i)
                    for i in range(3)]
            ps.push_sgwu(subs, virtual_time=0.5 * step)
            for i in range(3):
                ps.pull(i)
        out += [ps.version, ps.comm_bytes, ps.outstanding_versions(j)]
    return out + [ps.state_dict()], ps


PUSHES = [("agwu", 0, 0.5), ("agwu", 2, 1.2), ("delta", 1, 0.8),
          ("sgwu", 1, 0.0), ("agwu", 1, 0.3), ("stacked", 0, 0.0),
          ("stacked", 1, 0.0), ("delta", 2, 1.7), ("agwu", 0, 0.9)]


def test_parameter_server_bookkeeping_equals_the_reference():
    got, ps = _script(ParameterServer, _t, PUSHES)
    want, jps = _script(JServer, _j, PUSHES)
    assert got == want
    _close(ps.global_weights, jps.global_weights)
    fresh = ParameterServer(_t(_f32(_np_tree(np.random.default_rng(4)))), 3)
    fresh.load_state_dict(jps.state_dict())
    assert fresh.state_dict() == got[-1]


def test_parameter_server_errors():
    """The server's refusals, with the reference's messages; ``mesh=``
    (once not ported) refuses a mesh without a `nodes` axis as the
    reference's does."""
    w = _t(_f32(_np_tree(np.random.default_rng(5))))
    with pytest.raises(ValueError) as got:
        ParameterServer(w, 2, mesh=make_mesh("tiny", devices=[CPU] * 4))
    with pytest.raises(ValueError) as want:
        JServer(_f32(_np_tree(np.random.default_rng(5))), 2,
                mesh=jax.sharding.Mesh(np.asarray(jax.devices()[:1]),
                                       ("model",)))
    assert str(got.value) == str(want.value)
    ps = ParameterServer(w, 2)
    with pytest.raises(RuntimeError, match="never pulled"):
        ps.push_agwu(0, w, 1.0)
    ps.pull(0)
    with pytest.raises(RuntimeError, match="every worker"):
        ps.push_sgwu([(0, w, 1.0)])
    st, _ = ps.pull_all_stacked()
    with pytest.raises(ValueError, match="dead nodes must merge at 0"):
        ps.push_sgwu_stacked(st, [0.5, 0.5], active=[True, False])


def test_agwu_push_leaves_other_workers_bases_alone():
    """A worker's Eq. 10 base is the global tree it pulled, by reference:
    another worker's push must build a new global tree, not write into
    the one both pulled."""
    rng = np.random.default_rng(6)
    ps = ParameterServer(_t(_f32(_np_tree(rng))), num_workers=2)
    base0, _ = ps.pull(0)
    ps.pull(1)
    before = [x.clone() for x in tree_leaves(base0)]
    ps.push_agwu(1, _t(_f32(_np_tree(rng))), accuracy=0.9)
    for a, b in zip(before, tree_leaves(ps._base[0])):
        assert torch.equal(a, b)
    assert tree_leaves(ps._base[0])[0] is tree_leaves(base0)[0]
    assert not torch.equal(tree_leaves(ps.global_weights)[0], before[0])


def test_pulled_stack_writes_stay_in_their_node():
    """The stacked pull (fresh and rebroadcast after a merge) gives every
    node its own buffer: writing into node 0 changes neither the global
    weights nor node 1."""
    rng = np.random.default_rng(7)
    ps = ParameterServer(_t(_f32(_np_tree(rng))), num_workers=2)
    for _ in range(2):                      # fresh, then the rebroadcast
        stacked, _ = ps.pull_all_stacked()
        glob = [x.clone() for x in tree_leaves(ps.global_weights)]
        node1 = [x[1].clone() for x in tree_leaves(stacked)]
        for leaf in tree_leaves(stacked):
            leaf[0].add_(1.0)
        for g, x in zip(glob, tree_leaves(ps.global_weights)):
            assert torch.equal(g, x)
        for n1, x in zip(node1, tree_leaves(stacked)):
            assert torch.equal(n1, x[1])
        ps.push_sgwu_stacked(stacked, [0.3, 0.7])
