"""``repro_torch.launch.roofline`` and the dry-run's analytic terms against
the reference: ``model_flops`` for all 33 (arch, shape) pairs,
``dryrun._attn_score_bytes`` and ``_banded_flops_corr`` with and without
the ``opt`` variant (the reference's computed in a subprocess: importing
``repro.launch.dryrun`` forces 512 host devices on the importing process),
``RooflineReport.terms`` and ``row`` given the same ``HW``, and the
collective recorder on a fake 4-rank mesh: a column-parallel matmul and a
row-parallel one give the all-gather and all-reduce bytes worked out by
hand, and a replicated matmul counts chips x its FLOPs.  The dry-run's
depth extrapolation: for a uniform reduced config (Yi-6B's, no windows)
at 4 layers on ``tiny``, the 1-/2-layer extrapolation of FLOPs,
collective bytes and collective counts equals the 4-layer run's (train,
prefill, decode at a 64-token shape).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.types import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import placeholder_mesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = sorted(configs.pairs())
REF_HW = roofline.HW(peak_flops=jroofline.HW().peak_flops,
                     hbm_bw=jroofline.HW().hbm_bw,
                     ici_bw=jroofline.HW().ici_bw)


def test_pairs_equal_reference():
    assert len(PAIRS) == 33
    assert PAIRS == sorted(jconfigs.pairs())
    assert configs.SKIPS == jconfigs.SKIPS
    assert configs.LONG_CONTEXT_OK == jconfigs.LONG_CONTEXT_OK
    assert sorted(configs.pairs(include_skips=True)) == \
        sorted(jconfigs.pairs(include_skips=True))


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_model_flops_equal_reference(arch, shape):
    got = roofline.model_flops(configs.get_config(arch),
                               configs.get_shape(shape))
    want = jroofline.model_flops(jconfigs.get_config(arch),
                                 jconfigs.get_shape(shape))
    assert got == want


@pytest.fixture(scope="module")
def reference_terms():
    code = textwrap.dedent(f"""
        import json
        from repro import configs
        from repro.launch import dryrun
        out = {{}}
        for arch, shape in configs.pairs():
            for variant in ("", "opt"):
                cfg = configs.get_config(arch, variant)
                shp = configs.get_shape(shape)
                out[f"{{arch}}|{{shape}}|{{variant}}"] = [
                    dryrun._attn_score_bytes(cfg, shp),
                    dryrun._banded_flops_corr(cfg, shp)]
        out["SCORE"] = dryrun.SCORE_BYTES_PER_ELEM
        print(json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("variant", ["", "opt"])
@pytest.mark.parametrize("arch,shape", PAIRS)
def test_score_and_banded_terms_equal_reference(arch, shape, variant,
                                                reference_terms):
    cfg = configs.get_config(arch, variant)
    shp = configs.get_shape(shape)
    want = reference_terms[f"{arch}|{shape}|{variant}"]
    assert [dryrun._attn_score_bytes(cfg, shp),
            dryrun._banded_flops_corr(cfg, shp)] == want
    assert dryrun.SCORE_BYTES_PER_ELEM == reference_terms["SCORE"]


REPORTS = [
    dict(arch="x", shape="y", mesh="pod", chips=256, hlo_flops=1e15,
         hlo_bytes=1e12, coll_bytes=1e13, coll_detail={}, model_flops_=5e14,
         per_device_hbm=1e9),
    dict(arch="a", shape="b", mesh="multipod", chips=512, hlo_flops=3e18,
         hlo_bytes=2e14, coll_bytes=1e12, coll_detail={"all-gather": 3},
         model_flops_=1e18, per_device_hbm=3.5e10),
    dict(arch="c", shape="d", mesh="tiny", chips=4, hlo_flops=0.0,
         hlo_bytes=7e11, coll_bytes=0.0, coll_detail={}, model_flops_=1e9,
         per_device_hbm=1.0),
]


@pytest.mark.parametrize("kw", REPORTS)
def test_report_terms_and_row_equal_reference(kw, monkeypatch):
    port = roofline.RooflineReport(**kw)
    ref = jroofline.RooflineReport(**kw)
    assert port.terms(REF_HW) == ref.terms(jroofline.HW())
    # row() scores with the default rates on both sides
    monkeypatch.setattr(roofline, "LM_HW", REF_HW)
    assert port.row() == ref.row()


def test_lm_rates():
    assert roofline.LM_HW.peak_flops == 989e12
    assert roofline.HW() == roofline.HW(67e12, 3.35e12, 450e9)
    assert roofline.LM_HW.hbm_bw == roofline.HW().hbm_bw
    assert roofline.LM_HW.ici_bw == roofline.HW().ici_bw


MESH4 = types.SimpleNamespace(shape={"model": 4}, axis_names=("model",))


def _record(fn, *args):
    return dryrun.LoweredStep(fn=fn, args=args, argument_bytes=0,
                              rules=None).compile()


def test_recorder_counts_collectives_by_hand():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with dryrun.fake_world(MESH4) as dm, FakeTensorMode():
        x = distribute_tensor(torch.zeros(8, 16), dm, [Replicate()])
        w1 = distribute_tensor(torch.zeros(16, 32), dm, [Shard(1)])
        w2 = distribute_tensor(torch.zeros(32, 16), dm, [Shard(0)])

        def column_then_gather(x, w1):
            return (x @ w1).redistribute(dm, [Replicate()])

        def row_parallel(h, w2):
            return (h @ w2).redistribute(dm, [Replicate()])

        col = _record(column_then_gather, x, w1)
        h = distribute_tensor(torch.zeros(8, 32), dm, [Shard(1)])
        row = _record(row_parallel, h, w2)
        rep = _record(lambda a, b: a @ b,
                      distribute_tensor(torch.zeros(8, 16), dm,
                                        [Replicate()]),
                      distribute_tensor(torch.zeros(16, 32), dm,
                                        [Replicate()]))
    assert not torch.distributed.is_initialized()
    # column-parallel: each device multiplies (8, 16) by its (16, 8)
    # columns, then the (8, 32) f32 output is gathered: 1024 bytes
    assert col.coll == {"all-gather": 8 * 32 * 4,
                        "_counts": {"all-gather": 1}}
    assert col.flops == 2 * 8 * 16 * 8
    assert dryrun._costs(col, 4)[0] == 2 * 8 * 16 * 32
    # row-parallel: the (8, 16) partial sums are all-reduced: 512 bytes
    assert row.coll == {"all-reduce": 8 * 16 * 4,
                        "_counts": {"all-reduce": 1}}
    # replicated: every device does the whole product, counted 4 times
    assert rep.coll == {"_counts": {}}
    assert rep.flops == 2 * 8 * 16 * 32
    flops, _, cbytes, counts = dryrun._costs(rep, 4)
    assert flops == 4 * 2 * 8 * 16 * 32 and cbytes == 0 and counts == {}
    # analyze_compiled reads the step per device, as the reference reads
    # its compiled artifact
    report = roofline.analyze_compiled(col, "x", "y", "tiny", 4)
    assert report.hlo_flops == col.flops and report.coll_bytes == 8 * 32 * 4
    assert report.per_device_hbm == col.temp + col.output_bytes
    assert report.model_flops_ == 0.0


def test_recorder_refuses_setup_collectives():
    with pytest.raises(RuntimeError, match="set-up"):
        roofline._kind(torch.ops.c10d.broadcast_.default)
    assert roofline._kind(torch.ops.aten.mm.default) is None
    assert roofline.collective_bytes(
        {"all-gather": 3, "all-reduce": 4, "_counts": {"all-gather": 1}}) == 7


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_two_layer_extrapolation_equals_four_layers(mode):
    cfg = dataclasses.replace(configs.get_reduced("yi-6b"), num_layers=4)
    assert cfg.sliding_window == 0          # every layer alike
    shape = ShapeConfig("t64", seq_len=64, global_batch=8, mode=mode)
    mesh = placeholder_mesh("tiny")
    runs = dryrun._run_depths(cfg, shape, mesh, depths=(1, 2, 4))
    assert not torch.distributed.is_initialized()
    per = {k: dryrun._costs(runs[k], 4) for k in (1, 2, 4)}
    cal = dryrun.calibrated_costs(cfg, shape, mesh,
                                  per={1: per[1], 2: per[2]})
    assert per[2][0] > per[1][0] > 0
    assert cal["flops"] == per[4][0]
    assert cal["coll_bytes"] == per[4][2]
    assert cal["coll_counts"] == per[4][3]
