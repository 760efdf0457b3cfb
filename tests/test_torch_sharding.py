"""``repro_torch.launch.sharding`` against ``repro.launch.sharding``: for all
10 archs on the ``pod``, ``multipod``, ``tiny`` and ``tiny3d`` meshes,
``param_specs``, ``opt_state_specs``, ``logical_rules``, ``batch_specs``
(every shape) and ``cache_specs`` (``decode_32k``, and ``long_500k`` at
batch 1) equal the reference's exactly, leaf by leaf over the same path
names.  The reference's functions run on a stand-in mesh (its shape and
axis names) over ``jax.eval_shape`` trees; the port's over its ``meta``
trees.  Also ``make_production_mesh``'s shapes.
"""
import functools
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import MESHES as JMESHES  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.shardlib import P  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding, steps  # noqa: E402

MESH_NAMES = ("pod", "multipod", "tiny", "tiny3d")


def _mesh(name):
    shape, axes = JMESHES[name]
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=tuple(axes))


def _key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def _flat_ref(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(_key(k) for k in path): tuple(spec)
            for path, spec in leaves}


def _flat_port(tree, path=()):
    if isinstance(tree, P):
        return {"/".join(path): tuple(tree)}
    out = {}
    if hasattr(tree, "__dataclass_fields__"):
        items = [(f, getattr(tree, f)) for f in tree.__dataclass_fields__]
    elif isinstance(tree, dict):
        items = list(tree.items())
    else:
        items = [(str(i), v) for i, v in enumerate(tree)]
    for k, v in items:
        out.update(_flat_port(v, path + (k,)))
    return out


@functools.lru_cache(maxsize=None)
def _trees(arch):
    jcfg, tcfg = jconfigs.get_config(arch), configs.get_config(arch)
    return (jcfg, tcfg, jsteps.abstract_params(jcfg),
            steps.abstract_params(tcfg))


ARCHS = configs.ARCH_NAMES
CASES = [(a, m) for a in ARCHS for m in MESH_NAMES]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_param_specs_equal_reference(arch, mesh):
    _, _, jp, tp = _trees(arch)
    m = _mesh(mesh)
    want = _flat_ref(jsharding.param_specs(jp, m))
    got = _flat_port(sharding.param_specs(tp, m))
    assert got == want


@pytest.mark.parametrize("arch,mesh", CASES)
def test_opt_state_specs_equal_reference(arch, mesh):
    jcfg, tcfg, jp, tp = _trees(arch)
    m = _mesh(mesh)
    want = _flat_ref(jsharding.opt_state_specs(
        jsteps.abstract_opt_state(jcfg), jp, m))
    got = _flat_port(sharding.opt_state_specs(
        steps.abstract_opt_state(tcfg), tp, m))
    assert got == want


@pytest.mark.parametrize("arch,mesh", CASES)
def test_logical_rules_equal_reference(arch, mesh):
    jcfg, tcfg, _, _ = _trees(arch)
    m = _mesh(mesh)
    assert sharding.logical_rules(m, tcfg) == \
        jsharding.logical_rules(m, jcfg)
    assert sharding.logical_rules(m) == jsharding.logical_rules(m)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_batch_specs_equal_reference(arch, mesh):
    jcfg, tcfg, _, _ = _trees(arch)
    m = _mesh(mesh)
    for name in configs.SHAPES:
        shape = configs.get_shape(name)
        jshape = jconfigs.get_shape(name)
        want = _flat_ref(jsharding.batch_specs(
            jsteps.input_specs(jcfg, jshape), m, jshape.mode))
        got = _flat_port(sharding.batch_specs(
            steps.input_specs(tcfg, shape), m, shape.mode))
        assert got == want, name


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch,mesh", CASES)
def test_cache_specs_equal_reference(arch, mesh, shape_name):
    jcfg, tcfg, _, _ = _trees(arch)
    m = _mesh(mesh)
    shape, jshape = configs.get_shape(shape_name), \
        jconfigs.get_shape(shape_name)
    want = _flat_ref(jsharding.cache_specs(
        jsteps.abstract_cache(jcfg, jshape), m, jshape.global_batch))
    got = _flat_port(sharding.cache_specs(
        steps.abstract_cache(tcfg, shape), m, shape.global_batch))
    assert got == want


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh(multi_pod):
    m = tmesh.make_production_mesh(multi_pod=multi_pod)
    shape, axes = JMESHES["multipod" if multi_pod else "pod"]
    assert m.axis_names == tuple(axes)
    assert tuple(m.shape.values()) == tuple(shape)
    assert m.devices.size == (512 if multi_pod else 256)
