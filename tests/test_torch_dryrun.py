"""The port's dry-run (``repro_torch.launch.dryrun``), hillclimb and
refresh_rooflines on the CPU.

- argument bytes: the dry-run's ``argument_size_in_bytes`` equals the sum
  of the local shard bytes implied by the reference's specs over the
  reference's abstract trees, for all 10 archs at four (shape, mesh)
  combinations, and the DTensors a built step takes hold exactly that;
- ``hillclimb --plan``: its rows equal the reference's ``plan_search`` for
  ``case1`` over 8 devices when both score with the reference's ``HW``;
- ``refresh()`` reproduces a stored roofline row;
- the reference's own tiny-mesh combinations, run as
  ``python -m repro_torch.launch.dryrun`` in a subprocess:
  ``granite-moe-3b-a800m decode_32k tiny``, ``hymba-1.5b long_500k
  tiny3d`` and ``mamba2-370m decode_32k tiny`` (calibrated); the other
  two are in ``tests/test_torch_dryrun_cli.py`` and the extrapolation
  check in ``tests/test_torch_roofline.py`` (each file under 60 s);
- a combination that fails is counted and ``main`` returns 1;
- importing the new modules starts no process group;
- the models and ``kernels/ops.py`` hold no DTensor branch: the dry-run
  swaps in its own model functions for its run only;
- records name the torch that wrote them, and ``refresh()`` and
  ``tools/dryrun_table.py`` refuse records of two versions.

Every in-process dry-run creates its fake process group and destroys it
before it returns.
"""
import json
import math
import os
import subprocess
import sys
import textwrap
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import MESHES as JMESHES  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, hillclimb, roofline  # noqa: E402
from repro_torch.launch import refresh_rooflines  # noqa: E402
from repro_torch.launch.mesh import placeholder_mesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
NEW_MODULES = ("repro_torch.core.shardlib", "repro_torch.launch.sharding",
               "repro_torch.launch.dryrun", "repro_torch.launch.hillclimb",
               "repro_torch.launch.refresh_rooflines",
               "repro_torch.launch.roofline")


def _ref_local_bytes(tree, specs, mesh_shape) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    total = 0
    for leaf, spec in zip(leaves, spec_leaves, strict=True):
        shp = list(leaf.shape)
        for dim, ax in enumerate(tuple(spec)):
            for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
                shp[dim] = -(-shp[dim] // mesh_shape[a])
        total += math.prod(shp) * np.dtype(leaf.dtype).itemsize
    return total


def _ref_argument_bytes(arch, shape_name, mesh_name) -> int:
    cfg, shape = jconfigs.get_config(arch), jconfigs.get_shape(shape_name)
    dims, axes = JMESHES[mesh_name]
    mesh = types.SimpleNamespace(shape=dict(zip(axes, dims)),
                                 axis_names=tuple(axes))
    params = jsteps.abstract_params(cfg)
    batch = jsteps.input_specs(cfg, shape)
    n = _ref_local_bytes(params, jsharding.param_specs(params, mesh),
                         mesh.shape)
    n += _ref_local_bytes(batch, jsharding.batch_specs(batch, mesh,
                                                       shape.mode),
                          mesh.shape)
    if shape.mode == "train":
        opt = jsteps.abstract_opt_state(cfg)
        n += _ref_local_bytes(opt, jsharding.opt_state_specs(opt, params,
                                                             mesh),
                              mesh.shape)
    elif shape.mode == "decode":
        cache = jsteps.abstract_cache(cfg, shape)
        n += _ref_local_bytes(cache, jsharding.cache_specs(
            cache, mesh, shape.global_batch), mesh.shape)
        n += 4          # cache_len, an int32 scalar
    return n


COMBOS = [("train_4k", "pod"), ("prefill_32k", "multipod"),
          ("decode_32k", "tiny"), ("long_500k", "tiny3d")]


@pytest.mark.parametrize("shape,mesh", COMBOS)
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_argument_bytes_equal_reference_specs(arch, shape, mesh):
    got = dryrun.argument_bytes(configs.get_config(arch),
                                configs.get_shape(shape),
                                placeholder_mesh(mesh))
    assert got == _ref_argument_bytes(arch, shape, mesh)


def test_built_step_holds_the_argument_bytes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = configs.get_config("granite-moe-3b-a800m")
    shape = configs.get_shape("decode_32k")
    mesh = placeholder_mesh("tiny")
    with dryrun.fake_world(mesh) as dm, FakeTensorMode():
        low = dryrun.build_lowered(cfg, shape, mesh, dm)
        held = sum(t.to_local().numel() * t.to_local().element_size()
                   for t in dryrun._tensor_leaves(low.args))
    assert not torch.distributed.is_initialized()
    assert low.argument_bytes == held == \
        _ref_argument_bytes("granite-moe-3b-a800m", "decode_32k", "tiny")


def test_hillclimb_plan_equals_reference(monkeypatch):
    from repro.launch import hillclimb as jhillclimb
    from repro.launch import roofline as jroofline
    ref = jroofline.HW()
    rates = roofline.HW(peak_flops=ref.peak_flops, hbm_bw=ref.hbm_bw,
                        ici_bw=ref.ici_bw)
    monkeypatch.setattr(roofline, "HW", lambda: rates)
    got = hillclimb.plan_search("case1", 8, 32)
    want = jhillclimb.plan_search("case1", 8, 32)
    assert [(r["nodes"], r["model"], r["family"]) for r in got] == \
        [(r["nodes"], r["model"], r["family"]) for r in want]
    for g, w in zip(got, want, strict=True):
        assert g["layers"] == w["layers"]
        for key in ("inner_cost_s", "merge_cost_s_per_step", "step_cost_s",
                    "cost_per_sample_s"):
            assert g[key] == pytest.approx(w[key], rel=1e-12), key


def test_hillclimb_plan_cli(capsys):
    assert hillclimb.main(["--plan", "--cnn", "case1", "--devices", "4"]) \
        == 0
    out = capsys.readouterr().out
    rows = json.loads(out.split("\n", 1)[1])
    assert rows and {"nodes", "model", "family", "layers"} <= set(rows[0])
    assert hillclimb.parse_value("True") is True
    assert hillclimb.parse_value("3") == 3
    assert hillclimb.parse_value("0.5") == 0.5
    assert hillclimb.parse_value("gelu") == "gelu"


def test_refresh_reproduces_a_stored_row(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    res = dryrun.lower_and_compile("mamba2-370m", "decode_32k", "tiny",
                                   verbose=False)
    assert not torch.distributed.is_initialized()
    fn = dryrun.save_result(res, tag="refresh")
    row = dict(res["roofline"])
    with open(fn) as f:
        data = json.load(f)
    data["roofline"] = {"stale": True}
    with open(fn, "w") as f:
        json.dump(data, f)
    assert refresh_rooflines.refresh(str(tmp_path / "*.json")) == 1
    with open(fn) as f:
        assert json.load(f)["roofline"] == row


def run_dryrun(*args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=timeout)


def _record(name):
    with open(os.path.join(REPO, dryrun.OUT_DIR, name)) as f:
        return json.load(f)


def test_tiny_mesh_moe_decode():
    r = run_dryrun("--arch", "granite-moe-3b-a800m", "--shape",
                   "decode_32k", "--mesh", "tiny", "--no-calibrate",
                   "--tag", "test")
    assert r.returncode == 0, r.stderr[-3000:]
    data = _record("granite-moe-3b-a800m__decode_32k__tiny__test.json")
    assert data["chips"] == 4
    assert data["memory_analysis"]["temp_size_in_bytes"] > 0
    assert "roofline" not in data and "calibrated" not in data


def test_multipod_tiny3d():
    """The `pod` axis shards: a 3-level mesh runs the long-context decode
    (batch 1: the kv sequence sharded over every axis)."""
    r = run_dryrun("--arch", "hymba-1.5b", "--shape", "long_500k",
                   "--mesh", "tiny3d", "--no-calibrate", "--tag", "test")
    assert r.returncode == 0, r.stderr[-3000:]
    data = _record("hymba-1.5b__long_500k__tiny3d__test.json")
    assert data["chips"] == 8
    assert data["memory_analysis"]["argument_size_in_bytes"] > 0


def test_calibration_path():
    r = run_dryrun("--arch", "mamba2-370m", "--shape", "decode_32k",
                   "--mesh", "tiny", "--tag", "test")
    assert r.returncode == 0, r.stderr[-3000:]
    data = _record("mamba2-370m__decode_32k__tiny__test.json")
    row = data["roofline"]
    assert row["bottleneck"] in ("compute", "memory", "collective")
    assert data["calibrated"]["flops"] > 0
    assert data["calibrated"]["per_layer"]["flops"] > 0
    assert "memory_analysis.temp_size_in_bytes" in data["extrapolated"]


def test_failure_is_counted_and_returns_1(capsys):
    assert dryrun.main(["--arch", "yi-6b", "--shape", "decode_32k",
                        "--mesh", "tiny", "--variant", "nonesuch",
                        "--tag", "test"]) == 1
    assert "1 FAILURES" in capsys.readouterr().out


def test_imports_start_no_process_group():
    code = textwrap.dedent(f"""
        import importlib, sys
        import torch.distributed as dist
        for name in {NEW_MODULES!r}:
            importlib.import_module(name)
        assert not dist.is_initialized()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "repro")
                     or m.startswith("torch.testing._internal.distributed"))
        print(",".join(bad))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=ENV,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""


def test_model_paths_swapped_only_for_the_run(monkeypatch):
    """The models and ``kernels/ops.py`` hold no DTensor branch: a DTensor
    takes ``ops.dense``'s row path as a plain CPU tensor does, and only
    inside the dry-run's run (``_sharded_model_paths``) the dry-run's
    shard-local product on its leading dims; the swap is undone after it,
    the swapped mamba paths give the model's values on plain tensors, and
    the dry-run's versions refuse a tensor off the CPU."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention, encdec, layers, lm, mamba
    names = ((ops, "_dense_call"), (ops, "rmsnorm"), (attention, "write_kv"),
             (attention, "chunked_attention"), (attention, "_cache_contract"),
             (mamba, "_ssd_decode"), (mamba, "ssd_chunked"),
             (mamba, "_causal_conv"), (mamba, "_conv_tail"),
             (mamba, "_split_proj"), (mamba, "_split_conv"),
             (layers, "embed"), (lm, "embed"), (encdec, "embed"))
    before = [getattr(m, n) for m, n in names]
    seen = []
    dense_ref = ref.dense_ref
    monkeypatch.setattr(ref, "dense_ref", lambda x, *a, **k: (
        seen.append((type(x).__name__, x.ndim)), dense_ref(x, *a, **k))[1])
    local_einsum = dryrun._local_einsum

    def shard_local(eq, *args, **kwargs):
        out = local_einsum(eq, *args, **kwargs)
        if out is not None:                # it took the DTensor operands
            seen.append(eq)
        return out
    monkeypatch.setattr(dryrun, "_local_einsum", shard_local)

    x = torch.randn(2, 6, 8, generator=torch.Generator().manual_seed(0))
    w = torch.randn(8, 4, generator=torch.Generator().manual_seed(1))
    table = {"table": w.T.contiguous()}
    tokens = torch.tensor([[0, 3, 1], [2, 2, 0]])
    ssd = [torch.rand(s, generator=torch.Generator().manual_seed(i))
           for i, s in enumerate(((2, 3, 4, 5), (2, 3), (3,), (2, 3, 4),
                                  (2, 5), (2, 5), (3,)))]
    # decode attention's two contractions with the cache: the scores
    # (q against k), then p @ v, bf16 operands as the cache holds them
    contract = [(eq, *(torch.randn(s, generator=torch.Generator().manual_seed(
        9 + i + j)).to(torch.bfloat16) for j, s in enumerate(shapes)))
        for i, (eq, shapes) in enumerate((
            ("bhgd,bkhd->bhgk", ((2, 3, 2, 4), (2, 5, 3, 4))),
            ("bhgk,bkhd->bhgd", ((2, 3, 2, 5), (2, 5, 3, 4)))))]
    # the prefill mixer's SSD (a ragged last chunk), conv, tail and split
    g = torch.Generator().manual_seed(5)
    chunked = [torch.randn(s, generator=g) for s in (
        (2, 11, 3, 4), (2, 11, 3), (3,), (2, 11, 5), (2, 11, 5), (3,))]
    chunked[1], chunked[2] = chunked[1].abs(), -chunked[2].abs()
    conv = [torch.randn(s, generator=g) for s in ((2, 11, 6), (4, 6), (6,))]
    plain = (ops.dense(x, w), lm.embed(table, tokens),
             mamba._ssd_decode(*ssd),
             mamba.ssd_chunked(*chunked, chunk=4, return_final_state=True),
             mamba._causal_conv(*conv), mamba._conv_tail(conv[0], 4,
                                                         torch.bfloat16),
             mamba._split_conv(conv[0], 1, 2, 2),
             mamba._split_proj(x, 1, 2, 1))
    with dryrun._sharded_model_paths():
        assert all(getattr(m, n) is not b
                   for (m, n), b in zip(names, before, strict=True))
        assert torch.equal(ops.dense(x, w), plain[0])
        assert torch.equal(lm.embed(table, tokens), plain[1])
        for got, want in zip(mamba._ssd_decode(*ssd), plain[2],
                             strict=True):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        for eq, a, b in contract:
            assert torch.equal(attention._cache_contract(eq, a, b),
                               torch.einsum(eq, a.float(), b.float()))
        for got, want in zip(
                mamba.ssd_chunked(*chunked, chunk=4, return_final_state=True),
                plain[3], strict=True):
            assert torch.equal(got, want)
        assert torch.equal(mamba._causal_conv(*conv), plain[4])
        assert torch.equal(mamba._conv_tail(conv[0], 4, torch.bfloat16),
                           plain[5])
        assert all(torch.equal(a, b) for a, b in zip(
            mamba._split_conv(conv[0], 1, 2, 2), plain[6], strict=True))
        assert all(torch.equal(a, b) for a, b in zip(
            mamba._split_proj(x, 1, 2, 1), plain[7], strict=True))
        meta = [t.to("meta") for t in conv]
        for call in (lambda: mamba.ssd_chunked(*(t.to("meta")
                                                 for t in chunked)),
                     lambda: mamba._causal_conv(*meta),
                     lambda: mamba._conv_tail(meta[0], 4, torch.bfloat16),
                     lambda: mamba._split_conv(meta[0], 1, 2, 2),
                     lambda: mamba._split_proj(meta[0], 1, 2, 1)):
            with pytest.raises(NotImplementedError):
                call()
        with pytest.raises(NotImplementedError):
            ops.rmsnorm(torch.empty(2, 8, device="meta"),
                        torch.empty(8, device="meta"))
        with pytest.raises(NotImplementedError):
            attention._cache_contract(
                contract[1][0], *(t.to("meta") for t in contract[1][1:]))
    assert [getattr(m, n) for m, n in names] == before
    assert seen == [("Tensor", 2), ("Tensor", 3)]

    seen.clear()
    mesh = placeholder_mesh("tiny")
    with dryrun.fake_world(mesh) as dm, FakeTensorMode():
        xd = DTensor.from_local(torch.zeros(1, 6, 8), dm,
                                (Shard(0), Replicate()), run_check=False,
                                shape=(2, 6, 8), stride=(48, 8, 1))
        wd = DTensor.from_local(torch.zeros(8, 4), dm,
                                (Replicate(), Replicate()), run_check=False)
        outside = ops.dense(xd, wd)
        with dryrun._sharded_model_paths():
            inside = ops.dense(xd, wd)
    assert not torch.distributed.is_initialized()
    assert outside.shape == inside.shape == (2, 6, 4)
    assert seen == [("DTensor", 2), "aby,yz->abz"]


def test_records_of_two_torch_versions_are_refused(tmp_path, capsys):
    """Every record names the torch that wrote it; ``refresh()`` and
    ``tools/dryrun_table.py`` refuse records of two versions."""
    from tools import dryrun_table
    for i, (arch, shape) in enumerate(sorted(configs.pairs())[:2]):
        with open(tmp_path / f"{arch}__{shape}__pod.json", "w") as f:
            json.dump({"arch": arch, "shape": shape, "mesh": "pod",
                       "torch": f"2.{11 + i}.0"}, f)
    with pytest.raises(ValueError, match="torch versions"):
        refresh_rooflines.refresh(str(tmp_path / "*.json"))
    assert dryrun_table.main(["--meshes", "pod", "--dir",
                              str(tmp_path)]) == 1
    out, err = capsys.readouterr()
    assert "torch versions" in err and "| arch |" not in out
    assert dryrun.torch_version_of([{"torch": "2.13.0"}] * 2) == "2.13.0"
    with pytest.raises(ValueError):
        dryrun.torch_version_of([{"torch": "2.13.0"}, {}])


def test_flop_sites_splits_a_layer_into_forward_and_backward(tmp_path,
                                                             capsys):
    """``tools/flop_sites.py``: a site's per-layer FLOPs are its 2-layer
    count less its 1-layer count; autograd's sites (innermost frame at
    ``value_and_grad``'s ``torch.autograd.grad``) are the backward's;
    two records list the sites whose FLOPs differ, the largest first."""
    from tools import flop_sites
    grad = flop_sites._grad_site()
    fwd = "mm [[8, 4], [4, 2]] @ kernels/ops.py:61 < models/layers.py:56"
    bwd = f"mm [[4, 8], [8, 2]] @ {grad} < launch/steps.py:107"
    head = "mm [[8, 4], [4, 9]] @ models/lm.py:1"
    records = [
        {"L1": {fwd: [2, 128], bwd: [2, 256], head: [1, 576]},
         "L2": {fwd: [4, 256], bwd: [4, 512], head: [1, 576]}},
        {"L1": {fwd: [2, 128], bwd: [1, 128], head: [1, 576]},
         "L2": {fwd: [4, 256], bwd: [2, 256], head: [1, 576]}}]
    paths = []
    for i, sites in enumerate(records):
        paths.append(str(tmp_path / f"r{i}.json"))
        with open(paths[-1], "w") as f:
            json.dump({"arch": "a", "shape": "s", "mesh": "m",
                       "torch": "2.13.0", "flop_sites": sites}, f)
    layer = flop_sites.per_layer({"flop_sites": records[0]})
    assert layer == {fwd: (2, 128), bwd: (2, 256)}
    assert flop_sites.split(layer) == (128, 256)
    assert flop_sites.main(paths) == 0
    out = capsys.readouterr().out.splitlines()
    assert "backward / forward 2.0000" in out[0]
    assert "backward / forward 1.0000" in out[1]
    assert len(out) == 4 and out[3].endswith(bwd)


def test_coll_sites_counts_a_layer_and_outside_at_f32_width(tmp_path,
                                                            capsys):
    """``tools/coll_sites.py``: a site's per-layer bytes are its 2-layer
    bytes less its 1-layer bytes, its ``outside`` bytes twice the 1-layer
    run's less the 2-layer run's, each floating payload at 4 bytes an
    element; two records list the sites whose bytes differ."""
    from tools import coll_sites
    layer = "all-gather all_gather_into_tensor bfloat16[8,4] @ models/a.py:1"
    head = "all-reduce all_reduce float32[8] @ models/lm.py:2"
    ids = "all-gather all_gather_into_tensor int64[8] @ models/moe.py:3"
    records = [
        {"L1": {layer: [1, 64], head: [1, 32], ids: [1, 64]},
         "L2": {layer: [2, 128], head: [1, 32], ids: [2, 128]}},
        {"L1": {layer: [1, 64], head: [2, 64], ids: [1, 64]},
         "L2": {layer: [2, 128], head: [2, 64], ids: [2, 128]}}]
    assert coll_sites.f32_bytes(layer, 64) == 128
    assert coll_sites.per_layer({"coll_sites": records[0]}) == {
        layer: (1, 128), ids: (1, 64)}
    assert coll_sites.per_layer({"coll_sites": records[0]},
                                outside=True) == {head: (1, 32)}
    paths = []
    for i, sites in enumerate(records):
        paths.append(str(tmp_path / f"r{i}.json"))
        with open(paths[-1], "w") as f:
            json.dump({"arch": "a", "shape": "s", "mesh": "m",
                       "torch": "2.13.0", "coll_sites": sites}, f)
    assert coll_sites.main(paths + ["--outside"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith("0.000 MB") and out[1].endswith("0.000 MB")
    assert len(out) == 4 and out[3].endswith(head)
    assert "1 x 0.000 -> 2 x 0.000" in out[3]


def test_dryrun_probe_holds_a_record_to_the_reference():
    """``tools/dryrun_probe.py``: a record's calibrated collective bytes
    at f32 width over the reference's, in band within 1.5x (2x outside)
    both ways."""
    from tools import dryrun_probe
    want = dryrun_probe.REFERENCE["mamba2-370m"]
    L = configs.get_config("mamba2-370m").num_layers
    # chips x (L1, L2) bytes: a layer d, outside o, total o + L d
    d, o = want[1], want[2]
    site = "all-reduce all_reduce float32[1] @ models/a.py:1"
    record = {"arch": "mamba2-370m", "variant": "", "chips": 4,
              "coll_sites": {"L1": {site: [1, (o + d) // 4]},
                             "L2": {site: [2, (o + 2 * d) // 4]}}}
    r = dryrun_probe.ratios(record, "mamba2-370m")
    assert r[1:] == pytest.approx((1.0, 1.0), rel=1e-9)
    assert r[0] == pytest.approx((o + L * d) / want[0], rel=1e-9)
    assert dryrun_probe.in_band((1.4, 0.7, 1.9))
    assert not dryrun_probe.in_band((1.6, 1.0, 1.0))
    assert not dryrun_probe.in_band((1.0, 1.0, 0.4))
