"""K1 (fused dense forward) in the port against the JAX package's
``ops.dense``, through the reference's jnp path and its Pallas kernel in
interpret mode, and the CUDA wrapper's contract.  The kernel itself is
held against its plain version on a card in ``test_torch_kernels_cuda.py``.
"""
import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import build, dense, ops, ref  # noqa: E402

# (x shape, Din, Dout, bias, activation, dtype)
CASES = {
    "lead-dims": ((2, 3), 16, 24, False, "none", "float32"),
    "bias-relu": ((8,), 32, 40, True, "relu", "float32"),
    "bias-none": ((6,), 24, 16, True, "none", "float32"),
    "ragged": ((5,), 7, 9, True, "relu", "float32"),
    "bf16-relu": ((4,), 64, 48, True, "relu", "bfloat16"),
    "bf16-lead": ((2, 3), 32, 40, False, "none", "bfloat16"),
}


def _inputs(lead, din, dout, bias, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, din)).astype(np.float32)
    w = (rng.standard_normal((din, dout)) / np.sqrt(din)).astype(np.float32)
    b = rng.standard_normal((dout,)).astype(np.float32) if bias else None
    return x, w, b


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_dense_matches_jax(case, impl):
    lead, din, dout, bias, act, dtype = CASES[case]
    x, w, b = _inputs(lead, din, dout, bias, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    want = jops.dense(jnp.asarray(x, jdt), jnp.asarray(w), None if b is None
                      else jnp.asarray(b), activation=act, impl=impl)
    want = np.asarray(want.astype(jnp.float32))
    got = ops.dense(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                    None if b is None else torch.from_numpy(b),
                    activation=act)
    assert got.dtype == tdt and got.shape == (*lead, dout)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_bad_activation_raises():
    x, w, _ = _inputs((2,), 4, 3, False, "float32")
    with pytest.raises(ValueError):
        ops.dense(torch.from_numpy(x), torch.from_numpy(w), activation="gelu")


def test_cpu_path_never_builds(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the CPU path must not build a kernel")
    monkeypatch.setattr(build, "build", boom)
    x, w, _ = _inputs((3,), 8, 5, False, "float32")
    before = dense.dense_cuda.launches
    ops.dense(torch.from_numpy(x), torch.from_numpy(w))
    assert dense.dense_cuda.launches == before


class TestCudaWrapperContract:
    """What ``dense_cuda`` refuses, checked before any launch."""

    def _xw(self, dtype=torch.float32):
        return torch.ones((4, 8), dtype=dtype), torch.ones((8, 3), dtype=dtype)

    def test_cpu_tensor_raises(self):
        x, w = self._xw()
        with pytest.raises(ValueError, match="CUDA"):
            dense.dense_cuda(x, w)

    def test_requires_grad_raises(self):
        x, w = self._xw()
        with pytest.raises(RuntimeError, match="forward-only"):
            dense.dense_cuda(x, w.requires_grad_())

    @pytest.mark.parametrize("bad", ["dtype", "mixed", "shape", "bias"])
    def test_bad_inputs_raise(self, bad):
        x, w = self._xw()
        b = None
        if bad == "dtype":
            x, w = x.double(), w.double()
        elif bad == "mixed":
            w = w.to(torch.bfloat16)
        elif bad == "shape":
            w = torch.ones((7, 3))
        else:
            b = torch.ones((4,))
        with pytest.raises((TypeError, ValueError)):
            dense.dense_cuda(x, w, b)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(build.KernelBuildError, match="nvcc"):
        build.build()


TPU_KERNELS = {   # kernel library -> the Pallas kernels its source replaces
    "dense_fwd": ("_dense_fwd_kernel",),
    "dense_bwd": ("_dense_dx_kernel", "_dense_dwdb_kernel"),
    "conv2d": ("_conv_fwd_kernel", "_conv_dx_kernel", "_conv_dw_kernel"),
    "pool2d": ("_pool_fwd_kernel", "_pool_bwd_kernel"),
    "rmsnorm": ("_rmsnorm_kernel",),
    "flash_attention": ("_flash_kernel",),
}


def test_sources_ship_and_name_the_tpu_kernel():
    assert set(build.SOURCES) == set(TPU_KERNELS)
    for name, rel in build.SOURCES.items():
        src = (os.path.dirname(build.__file__) + "/" + rel)
        text = open(src).read()
        assert "sm_90a" in text
        assert all(k in text for k in TPU_KERNELS[name]), name
