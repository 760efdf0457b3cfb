"""K9 (RMSNorm) in the port against the JAX package: ``ops.rmsnorm``
(the plain version on the CPU) against ``rmsnorm_pallas`` in interpret
mode and ``ops.rmsnorm(impl="pallas")``, and the port's ``layers.rms_norm``
(which goes through ``ops.rmsnorm``) against the reference's layer; plus
the CUDA wrapper's contract.  The kernel itself is held against its plain
version on a card in ``test_torch_kernels_cuda.py``.

Tolerances: f32 atol 1e-5, rtol 1e-4, the reference's own for K9
(``tests/test_kernels.py``); bf16 one rounding of the output (rtol 2^-7).
Seeded numpy cases, not ``@given``.
"""
import math
import re

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_pallas  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.models import layers  # noqa: E402

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=2.0 ** -7)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    s = (rng.standard_normal((shape[-1],)) * 0.1 + 1.0).astype(np.float32)
    return x, s


def _port(x, s, dtype):
    out = ops.rmsnorm(torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(s))
    assert out.dtype == TDT[dtype] and tuple(out.shape) == x.shape
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 64, 128, 512])
@pytest.mark.parametrize("rows", [1, 37, 256, 300])
def test_matches_pallas(rows, d, dtype):
    x, s = _inputs((rows, d), seed=rows * 1000 + d)
    want = rmsnorm_pallas(jnp.asarray(x, JDT[dtype]), jnp.asarray(s),
                          row_tile=64)
    _close(_port(x, s, dtype), np.asarray(want.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 7, 64), (2, 3, 4, 32), (128,)],
                         ids=["3d", "4d", "1d"])
def test_nd_shapes_match_jax_ops(shape, dtype):
    x, s = _inputs(shape, seed=len(shape))
    want = jops.rmsnorm(jnp.asarray(x, JDT[dtype]), jnp.asarray(s),
                        impl="pallas")
    _close(_port(x, s, dtype), np.asarray(want.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_rms_norm_matches_jax(dtype, eps):
    """The LM's norm: f32 scale, x in the activation dtype."""
    x, s = _inputs((2, 9, 96), seed=11)
    want = jlayers.rms_norm({"scale": jnp.asarray(s)},
                            jnp.asarray(x, JDT[dtype]), eps)
    got = layers.rms_norm({"scale": torch.from_numpy(s)},
                          torch.from_numpy(x).to(TDT[dtype]), eps)
    assert got.dtype == TDT[dtype]
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)


def test_bf16_scale():
    """A bf16 scale (bf16 params) is read as f32, as the reference does."""
    x, s = _inputs((4, 48), seed=5)
    sb = jnp.asarray(s, jnp.bfloat16)
    want = rmsnorm_pallas(jnp.asarray(x), sb)
    got = ops.rmsnorm(torch.from_numpy(x),
                      torch.from_numpy(np.array(sb.astype(jnp.float32)))
                      .bfloat16())
    _close(got.numpy(), np.asarray(want), "float32")


def test_cpu_path_never_builds(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the CPU path must not build a kernel")
    monkeypatch.setattr(build, "build", boom)
    x, s = _inputs((3, 16), seed=0)
    before = rms.rmsnorm_cuda.launches
    out = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(s))
    assert rms.rmsnorm_cuda.launches == before
    assert torch.equal(out, ref.rmsnorm_ref(torch.from_numpy(x),
                                            torch.from_numpy(s)))


class TestCudaWrapperContract:
    """What ``rmsnorm_cuda`` and ``ops.rmsnorm`` refuse, checked before any
    launch."""

    def test_cpu_tensor_raises(self):
        with pytest.raises(ValueError, match="CUDA"):
            rms.rmsnorm_cuda(torch.ones((2, 8)), torch.ones((8,)))

    @pytest.mark.parametrize("bad", ["dtype", "scale-shape", "ndim"])
    def test_bad_inputs_raise(self, bad):
        x, s = torch.ones((2, 8)), torch.ones((8,))
        if bad == "dtype":
            x = x.double()
        elif bad == "scale-shape":
            s = torch.ones((7,))
        else:
            x = torch.ones((2, 2, 8))
        with pytest.raises((TypeError, ValueError)):
            rms.rmsnorm_cuda(x, s)

    def test_gradient_on_the_card_is_not_implemented(self):
        """Off the CPU a call that needs a gradient goes to the kernels
        (``RmsNormFunction``), as one that needs none does: neither gives
        way to the plain version (a meta tensor stands in for the card
        here, and the launcher refuses it).  K9's backward is written, so
        no path raises ``NotImplementedError`` any more."""
        x = torch.ones((2, 8), device="meta", requires_grad=True)
        s = torch.ones((8,), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            ops.rmsnorm(x, s)
        with pytest.raises(ValueError, match="CUDA"):
            ops.rmsnorm(x.detach(), s)
        with pytest.raises(ValueError, match="CUDA"):
            rms.rmsnorm_bwd_cuda(x.detach(), s, x.detach())


ROWS_PLAN = [1, 4, 16, 132, 133, 300, 3001, 4500, 5000]


@pytest.mark.parametrize("d,itemsize", [(4608, 2), (4608, 4), (4096, 2),
                                        (3072, 4), (64, 2), (9216, 4)])
@pytest.mark.parametrize("rows", ROWS_PLAN)
def test_plan_covers_every_row_once(rows, d, itemsize):
    """K9's row kernel: its blocks cover every row once, no block is
    empty, and a row fits its group within the register budget (at most
    9 vectors a thread, an instance of ``rmsnorm.cu``)."""
    plan = rms.rms_plan(rows, d, itemsize)
    nv = d * itemsize // 16
    assert plan.per_thread in rms._PER_THREAD
    assert plan.group % 32 == 0 and plan.block % plan.group == 0
    assert plan.block <= 256 and plan.group * plan.per_thread >= nv
    assert all(p * plan.group < nv for p in rms._PER_THREAD
               if p < plan.per_thread)     # the smallest instance that fits
    if rows <= 132:            # a block a row
        assert plan.block == plan.group and plan.grid == rows
    else:                      # the narrowest group that holds the row
        assert plan.block == 256
        assert plan.group == 32 or plan.group // 2 * 9 < nv
    per_block = plan.block // plan.group
    seen = np.zeros(rows, np.int64)
    for b in range(plan.grid):
        assert b * per_block < rows, f"block {b} has no row"
        seen[b * per_block:(b + 1) * per_block] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("rows,d,itemsize,aligned", [
    (4, 16384, 4, True), (5000, 16384, 2, True),   # scale past 48 KB
    (4, 12288, 4, True),                           # past 9 vectors a thread
    (3001, 4095, 2, True), (3, 13, 2, True),       # d off the 16-byte vector
    (37, 1002, 4, True),
    (4500, 4608, 2, False)])                       # rows off 16 bytes
def test_plan_takes_the_chunked_kernel_past_the_row_kernel(rows, d, itemsize,
                                                           aligned):
    plan = rms.rms_plan(rows, d, itemsize, aligned)
    assert plan.per_thread == 0 and plan.grid == rows
    assert plan.group == plan.block
    vectors = math.ceil(d / (16 // itemsize))
    assert plan.block == min(256, max(32, math.ceil(vectors / 32) * 32))


def test_plan_instances_are_the_kernels():
    """``_PER_THREAD`` lists exactly the NV instances rmsnorm.cu has."""
    src = (build.CSRC / "rmsnorm.cu").read_text()
    assert tuple(sorted(int(n) for n in re.findall(r"RMS_ROWS\((\d+)\)",
                                                   src))) == rms._PER_THREAD


@pytest.mark.parametrize("d,itemsize", [(3072, 2), (4608, 2), (3072, 4),
                                        (4608, 4), (4096, 4), (1000, 4),
                                        (64, 2), (12032, 4)])
@pytest.mark.parametrize("rows", [1, 7, 133, 1000, 1024, 5000])
def test_bwd_plan_covers_every_row_once(rows, d, itemsize):
    """K9's backward: its blocks cover every row once, none is empty, at
    most two blocks an SM (264 dscale partials); every vector of a row is
    held at up to 4 a thread (up to 12 at 256 threads), an instance of
    ``rmsnorm.cu``."""
    plan = rms.bwd_plan(rows, d, itemsize)
    nv = d * itemsize // 16
    assert plan.block % 32 == 0 and plan.block <= 256
    assert plan.per_thread in rms._BWD_PER_THREAD
    assert plan.block * plan.per_thread >= nv and plan.grid <= 264
    assert plan.per_thread <= 4 or plan.block == 256
    seen = np.zeros(rows, np.int64)
    for b in range(plan.grid):
        assert b * plan.rows_per_block < rows, f"block {b} has no row"
        seen[b * plan.rows_per_block:(b + 1) * plan.rows_per_block] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("rows,d,itemsize", [
    (1024, 3070, 2), (3, 13, 2), (37, 1002, 4)])
def test_bwd_plan_holds_a_ragged_row_in_registers(rows, d, itemsize):
    """A row that is no whole number of 16-byte vectors gets a last,
    partial vector: the plan covers ceil(d / V) of them, as the kernel
    counts them."""
    V = 16 // itemsize
    plan = rms.bwd_plan(rows, d, itemsize)
    assert plan.block * plan.per_thread >= math.ceil(d / V)
    assert plan.per_thread in rms._BWD_PER_THREAD


def test_bwd_plan_instances_are_the_kernels():
    """``_BWD_PER_THREAD`` lists exactly the backward's NV instances."""
    src = (build.CSRC / "rmsnorm.cu").read_text()
    assert tuple(sorted(int(n) for n in re.findall(
        r"RMS_BWD_ROWS\((\d+)\)", src))) == rms._BWD_PER_THREAD
