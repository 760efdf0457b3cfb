"""``repro_torch.core.shardlib``: the logical-axis rules against the
reference's ``repro.core.shardlib``, the no-op contract without rules (the
very object comes back, on every path of the port), and ``constrain`` /
``constrain_div`` / ``placements`` on DTensors over a fake process group of
4 ranks, created and destroyed by the fixture.
"""
import types

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.core import shardlib as jshardlib  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro_torch.core import shardlib  # noqa: E402
from repro_torch.core.shardlib import P  # noqa: E402
from repro_torch.launch import dryrun, sharding  # noqa: E402

TINY = types.SimpleNamespace(shape={"data": 2, "model": 2},
                             axis_names=("data", "model"))
MESHES = {
    "pod": types.SimpleNamespace(shape={"data": 16, "model": 16},
                                 axis_names=("data", "model")),
    "multipod": types.SimpleNamespace(
        shape={"pod": 2, "data": 16, "model": 16},
        axis_names=("pod", "data", "model")),
    "tiny": TINY,
}
AXES = [("batch", "seq", "embed"), ("batch", None, "heads", None),
        ("batch", None, "kv_heads", None), ("batch", "expert", "capacity",
                                            None), (None, "tp"),
        ("batch", None, "vocab"), ("batch", None, "mlp_ff")]


def test_no_rules_is_identity():
    assert shardlib.get_rules() is None
    x = torch.ones(2, 3, 4)
    assert shardlib.constrain(x, "batch", "seq", "embed") is x
    assert shardlib.constrain_div(x, "batch", "seq", "embed") is x


def test_rules_scope_restores():
    rules = sharding.logical_rules(TINY)
    with shardlib.rules_scope(rules):
        assert shardlib.get_rules() is rules
        with shardlib.rules_scope(None):
            assert shardlib.get_rules() is None
        assert shardlib.get_rules() is rules
    assert shardlib.get_rules() is None
    shardlib.set_rules(rules)
    try:
        assert shardlib.get_rules() is rules
    finally:
        shardlib.set_rules(None)


def test_plain_tensor_passes_through_with_rules():
    x = torch.ones(4, 6, 8)
    with shardlib.rules_scope(sharding.logical_rules(TINY)):
        assert shardlib.constrain(x, "batch", "seq", "embed") is x
        assert shardlib.constrain_div(x, "batch", "seq", None) is x
        with pytest.raises(ValueError):
            shardlib.constrain(x, "batch", "seq")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["yi-6b", "gemma2-27b",
                                  "granite-moe-3b-a800m"])
def test_spec_for_and_axis_size_match_reference(arch, mesh):
    from repro import configs as jconfigs
    from repro_torch import configs
    m = MESHES[mesh]
    rules = sharding.logical_rules(m, configs.get_config(arch))
    jrules = jsharding.logical_rules(m, jconfigs.get_config(arch))
    for axes in AXES:
        with shardlib.rules_scope(rules), jshardlib.rules_scope(jrules):
            assert tuple(shardlib.spec_for(*axes)) == \
                tuple(jshardlib.spec_for(*axes))
            for a in axes:
                ax = rules.get(a) if a else None
                assert shardlib._axis_size(ax) == jshardlib._axis_size(ax)


def test_p_holds_what_the_reference_holds():
    spec = P(("pod", "data"), None, "model")
    assert tuple(spec) == tuple(JP(("pod", "data"), None, "model"))
    assert repr(spec) == "P(('pod', 'data'), None, 'model')"
    assert P() == ()


@pytest.fixture
def world():
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2},
                                 axis_names=("data", "model"))
    with dryrun.fake_world(mesh) as dmesh:
        yield dmesh
    assert not torch.distributed.is_initialized()


def test_placements(world):
    from torch.distributed.tensor import Replicate, Shard
    assert shardlib.placements(P("data", None, "model"), world) == \
        (Shard(0), Shard(2))
    assert shardlib.placements(P(None, "model"), world) == \
        (Replicate(), Shard(1))
    assert shardlib.placements(P(("data", "model")), world) == \
        (Shard(0), Shard(0))
    assert shardlib.placements(P(), world) == (Replicate(), Replicate())
    with pytest.raises(ValueError):
        shardlib.placements(P("model", "model"), world)


def test_constrain_redistributes_dtensors(world):
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    x = distribute_tensor(torch.arange(4 * 6 * 8.).reshape(4, 6, 8), world,
                          [Replicate(), Replicate()])
    with shardlib.rules_scope(sharding.logical_rules(TINY)):
        y = shardlib.constrain(x, "batch", "seq", "embed")
        assert isinstance(y, DTensor)
        assert tuple(y.placements) == (Shard(0), Shard(1))
        assert shardlib.constrain(y, "batch", "seq", "embed") is y
        # seq 5 does not divide over `model`: constrain_div replicates it
        z = distribute_tensor(torch.zeros(4, 5, 8), world,
                              [Replicate(), Replicate()])
        w = shardlib.constrain_div(z, "batch", "seq", None)
        assert tuple(w.placements) == (Shard(0), Replicate())
    # a fake group moves no data: only the shapes can be held
    assert tuple(y.shape) == (4, 6, 8)
    assert tuple(y.to_local().shape) == (2, 3, 8)


def test_param_shardings_are_the_specs_placements(world):
    from repro_torch import configs
    from repro_torch.launch import steps
    cfg = configs.get_reduced("yi-6b")
    params = steps.abstract_params(cfg)
    specs = sharding.param_specs(params, TINY)
    pls = sharding.param_shardings(params, world)
    assert pls["layers"]["attn"]["wq"]["w"] == shardlib.placements(
        specs["layers"]["attn"]["wq"]["w"], world)
    assert pls["embed"]["table"] == shardlib.placements(
        specs["embed"]["table"], world)
