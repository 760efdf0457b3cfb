"""The port's CUDA kernels against their plain versions, on the card.

Imports torch only (no JAX), so it also runs where JAX is absent, with
``src`` on the import path and without the JAX-importing conftest:
``python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py``.

Every test decides in its body that there is no card and skips there.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dense, ops, ref  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,M,K,N", [
    ("bfloat16", 4, 4096, 512), ("bfloat16", 24, 4096, 4096),
    ("bfloat16", 5, 72, 70), ("float32", 37, 100, 77)])
def test_dense_kernel_matches_plain(dtype, M, K, N):
    _card()
    gen = torch.Generator("cuda").manual_seed(0)
    tdt = getattr(torch, dtype)
    x = torch.randn((M, K), generator=gen, device="cuda").to(tdt)
    w = torch.randn((K, N), generator=gen, device="cuda").to(tdt)
    b = torch.randn((N,), generator=gen, device="cuda")
    before = dense.dense_cuda.launches
    got = dense.dense_cuda(x, w, b, activation="relu")
    want = ref.dense_ref(x, w, b, activation="relu")
    torch.cuda.synchronize()
    assert dense.dense_cuda.launches == before + 1
    # bf16: one rounding of the output; f32: sums in another order
    tol = (1e-5 if dtype == "float32" else 1e-2) * want.abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_ops_dense_on_card_launches_the_kernel():
    _card()
    gen = torch.Generator("cuda").manual_seed(1)
    x = torch.randn((2, 3, 64), generator=gen, device="cuda").bfloat16()
    w = torch.randn((64, 40), generator=gen, device="cuda")
    before = dense.dense_cuda.launches
    out = ops.dense(x, w)
    torch.cuda.synchronize()
    assert dense.dense_cuda.launches == before + 1
    assert out.shape == (2, 3, 40) and out.dtype == torch.bfloat16
    want = ref.dense_ref(x, w)
    assert (out.float() - want.float()).abs().max().item() <= \
        1e-2 * want.float().abs().max().item()
