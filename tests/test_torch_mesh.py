"""The port's ``launch/mesh.py`` against the reference's: the MESHES table,
the builders' shapes, axes and errors (``tests/test_mesh.py``), over
explicit device pools (``[torch.device("cpu")] * n`` stands in for the
reference's forced host devices), and ``place``'s sync labels."""
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import mesh as jmesh  # noqa: E402
from repro_torch import sanitize  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402

CPU = torch.device("cpu")


def pool(n):
    return [CPU] * n


def test_meshes_table_equals_the_reference():
    assert mesh.MESHES == jmesh.MESHES


@pytest.mark.parametrize("name", sorted(jmesh.MESHES))
def test_make_mesh_shape_and_axes(name):
    shape, axes = jmesh.MESHES[name]
    n = math.prod(shape)
    got = mesh.make_mesh(name, devices=pool(n))
    assert got.axis_names == axes
    assert tuple(got.shape[a] for a in axes) == shape
    assert got.devices.shape == shape
    with pytest.raises(RuntimeError, match="devices") as e:
        mesh.make_mesh(name, devices=pool(n - 1))
    assert f"mesh {name} needs {n} devices, have {n - 1}" in str(e.value)
    assert "XLA_FLAGS" not in str(e.value) and "devices=" in str(e.value)


def test_unknown_name_raises():
    with pytest.raises(KeyError):
        mesh.make_mesh("nope", devices=pool(4))


@pytest.mark.parametrize("m", [1, 2, 5, 8])
def test_make_nodes_mesh(m):
    got = mesh.make_nodes_mesh(m, devices=pool(m + 1))
    assert got.shape == {"nodes": m} and got.axis_names == ("nodes",)
    assert [got.node_device(j, m) for j in range(m)] == pool(m)
    with pytest.raises(RuntimeError, match="nodes mesh") as e:
        mesh.make_nodes_mesh(m + 1, devices=pool(m))
    with pytest.raises(RuntimeError) as want:
        jmesh.make_nodes_mesh(m + 1, devices=jax.devices()[:1] * m)
    # the reference's words up to its hint, which names XLA_FLAGS
    assert str(e.value).split(" (")[0] == str(want.value).split(" (")[0]
    assert "devices=" in str(e.value)


@pytest.mark.parametrize("bad", [0, -1])
def test_bad_counts(bad):
    with pytest.raises(ValueError):
        mesh.make_nodes_mesh(bad, devices=pool(4))
    with pytest.raises(ValueError):
        mesh.make_hybrid_mesh(bad, 2, devices=pool(4))
    with pytest.raises(ValueError):
        mesh.make_hybrid_mesh(2, bad, devices=pool(4))


@pytest.mark.parametrize("n,k", [(2, 2), (4, 2), (2, 4), (8, 2)])
def test_hybrid_mesh(n, k):
    got = mesh.make_hybrid_mesh(n, k, devices=pool(n * k))
    assert got.axis_names == ("nodes", "model")
    assert got.shape == {"nodes": n, "model": k}
    named = mesh.make_mesh(f"nodes{n}xmodel{k}", devices=pool(n * k))
    assert named == got and hash(named) == hash(got)
    with pytest.raises(RuntimeError, match="hybrid mesh") as e:
        mesh.make_hybrid_mesh(n, k, devices=pool(n * k - 1))
    assert f"needs {n * k} devices ({n} nodes x {k} model)" in str(e.value)


def test_node_devices_follow_the_mesh_rows():
    devs = [torch.device("meta")] + [CPU] * 3
    m = mesh.Mesh(np.asarray(devs, dtype=object).reshape(2, 2),
                  ("nodes", "model"))
    assert m.model_devices(0, 2) == tuple(devs[:2])
    assert m.model_devices(1, 2) == tuple(devs[2:])
    assert m.node_device(1, 2) == CPU
    # four nodes on a 2-position axis: two nodes a position
    assert m.node_block(4) == 2 and m.node_device(1, 4) == devs[0]
    with pytest.raises(ValueError, match="do not divide"):
        m.node_block(3)


@pytest.mark.parametrize("name,want", [("nodes4", ()), ("tiny", ("data",)),
                                       ("tiny3d", ("pod", "data")),
                                       ("nodes2xmodel2", ())])
def test_data_axes(name, want):
    shape, _ = mesh.MESHES[name]
    assert mesh.data_axes(mesh.make_mesh(
        name, devices=pool(math.prod(shape)))) == want


def test_default_pool_is_the_visible_devices():
    want = [torch.device("cuda", i) for i in range(torch.cuda.device_count())
            ] if torch.cuda.is_available() else [CPU]
    assert mesh.default_devices() == want


def test_place_logs_no_move_on_one_device():
    sanitize.clear_sync_log()
    tree = {"a": torch.ones(2), "b": [torch.zeros(3)]}
    assert mesh.place(tree, "cpu") is tree
    copy = mesh.place_copy(tree, "cpu")      # a replica: buffers of its own
    for a, b in zip((copy["a"], copy["b"][0]), (tree["a"], tree["b"][0])):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert sanitize.sync_log() == []
