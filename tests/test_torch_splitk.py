"""The split-K products: how the reduction is cut for the f32 product
behind K1's f32 instance and K2 (``dense.dense_splits``) and for K1's
bf16 decode instance (``dense.bf16_splits``), and that the kernel
libraries rebuild when the header they share changes.  CPU only, no
``nvcc``: the kernels themselves are held against their plain versions on
a card in ``test_torch_kernels_cuda.py``.
"""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import build, dense  # noqa: E402

# (M, N, K) of C (M, N) = A (M, K) B (K, N): every case7 shape at B = 64
# (K1: (64, Dout, Din); K2: (64, Din, Dout)), short K, ragged shapes
CASE7 = [(64, 2000, 192), (64, 2000, 2000), (64, 10, 2000),     # K1
         (64, 192, 2000), (64, 2000, 10)]                        # K2
SHAPES = CASE7 + [(64, 64, 15), (64, 2000, 3), (64, 10, 10),
                  (37, 77, 100), (37, 77, 1000), (64, 200, 1002),
                  (5, 130, 3), (5, 3, 130), (1, 1, 1), (1, 1, 257),
                  (64, 4096, 4096), (4, 4096, 11008), (200, 3000, 5000)]


def _slices(K, splits):
    depth = dense.split_depth(K, splits)
    return [(z * depth, min(K, (z + 1) * depth)) for z in range(splits)]


@pytest.mark.parametrize("M,N,K", SHAPES)
def test_slices_cover_k_exactly_and_none_is_empty(M, N, K):
    splits = dense.dense_splits(M, N, K)
    assert splits >= 1 and splits == dense.dense_splits(M, N, K)
    slices = _slices(K, splits)
    assert slices[0][0] == 0 and slices[-1][1] == K
    for (a, b), (c, _) in zip(slices, slices[1:]):
        assert b == c                       # contiguous, no overlap
    assert all(b > a for a, b in slices)    # none empty
    assert all(a % 16 == 0 for a, _ in slices)   # on the kernel's K step
    # each slice at least _MIN_DEPTH deep, bar a short last one
    assert splits == 1 or all(b - a >= 128 for a, b in slices[:-1])


@pytest.mark.parametrize("M,N,K,want", [
    (64, 2000, 2000, 8),     # 32 tiles x 8 = 256 blocks, two an SM
    (64, 192, 2000, 14),     # K2's first FC layer: 3 tiles
    (64, 10, 2000, 14),      # K1's last layer: 1 tile
    (64, 2000, 192, 1),      # K1's first layer: K too short to split
    (64, 2000, 10, 1),       # K2's last layer
    (64, 10, 10, 1), (64, 64, 15, 1), (37, 77, 100, 1),
    (4096, 4096, 4096, 1),   # the tiles alone fill the card
])
def test_splits_fill_the_card_and_depend_on_shapes_only(M, N, K, want):
    assert dense.dense_splits(M, N, K) == want


@pytest.mark.parametrize("M,N,K", [(37, 77, 1000), (64, 200, 1002),
                                   (5, 130, 300)])
def test_slice_partials_added_in_order_give_the_product(M, N, K):
    """What pass 1 and pass 2 compute, in plain f32: each slice's partial
    product, then their sum in slice order, equals the whole product."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    total = torch.zeros((M, N))
    for lo, hi in _slices(K, dense.dense_splits(M, N, K)):
        total += a[:, lo:hi] @ b[lo:hi]
    want = a.double() @ b.double()
    assert (total.double() - want).abs().max().item() <= \
        1e-5 * want.abs().max().item()


# ----------------------------------------------------------------------
# K1's bf16 decode instance (M <= 16): a split-K weight stream
# ----------------------------------------------------------------------
BF16_STEP, BF16_MAX_DEPTH, SM_BLOCKS = 64, 1024, 264


def _projections(arch):
    """(K, N) of every projection one layer of ``arch`` makes: q, k, v, o,
    the MLP's gate and up, and its down projection."""
    c = configs.get_config(arch)
    q, kv = c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim
    return [(c.d_model, q), (c.d_model, kv), (c.d_model, kv), (q, c.d_model),
            (c.d_model, c.d_ff), (c.d_model, c.d_ff), (c.d_ff, c.d_model)]


LM_SHAPES = sorted({kn for arch in ("yi-6b", "phi3-mini-3.8b", "gemma2-27b")
                    for kn in _projections(arch)})
BF16_RAGGED = [(4100, 520), (1000, 77), (4099, 130), (36864, 100), (72, 70),
               (64, 64), (1, 1), (63, 4096), (65, 8), (2048, 33000)]


def test_lm_shapes_are_the_published_widths():
    assert {(4096, 4096), (4096, 512), (4096, 11008), (11008, 4096),
            (3072, 3072), (3072, 8192), (8192, 3072), (4608, 4096),
            (4608, 2048), (4096, 4608), (4608, 36864),
            (36864, 4608)} == set(LM_SHAPES)


@pytest.mark.parametrize("M", [1, 4, 16])
@pytest.mark.parametrize("K,N", LM_SHAPES + BF16_RAGGED)
def test_bf16_slices_cover_k_and_fill_the_card(M, K, N):
    splits, depth = dense.bf16_splits(M, N, K)
    assert (splits, depth) == dense.bf16_splits(M, N, K)   # shapes only
    assert depth % BF16_STEP == 0 and 0 < depth <= BF16_MAX_DEPTH
    slices = [(z * depth, min(K, (z + 1) * depth)) for z in range(splits)]
    assert slices[0][0] == 0 and slices[-1][1] == K
    assert all(b == c for (_, b), (c, _) in zip(slices, slices[1:]))
    assert all(b > a for a, b in slices)                  # none empty
    blocks = -(-N // 64) * splits
    steps = -(-K // BF16_STEP)
    if -(-N // 64) * steps >= SM_BLOCKS:     # K allows two blocks an SM
        assert blocks >= SM_BLOCKS
    else:                                    # as many slices as K steps
        assert splits == steps and depth == BF16_STEP


@pytest.mark.parametrize("M,K,N,want", [
    (4, 4096, 512, (64, 64)),      # Yi-6B wk/wv: 8 tiles, one step a slice
    (4, 4096, 4096, (5, 960)),     # 64 tiles x 5 = 320 blocks
    (4, 4096, 11008, (4, 1024)),   # the deepest slice: x rows fit smem
    (1, 36864, 4608, (36, 1024)),  # Gemma-2's down projection
    (16, 72, 70, (2, 64)),         # K too short for two blocks an SM
    (17, 4096, 512, (1, 0)),       # prefill: no split
    (24, 4096, 4096, (1, 0)),
])
def test_bf16_splits_depend_on_shapes_only(M, K, N, want):
    assert dense.bf16_splits(M, N, K) == want


def test_bf16_slice_partials_in_order_give_the_product():
    """What the bf16 instance's two passes compute, in plain f32: each
    slice's product of bf16 operands, then their sum in slice order."""
    rng = np.random.default_rng(1)
    M, K, N = 4, 4099, 130
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).bfloat16().float()
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)
                         ).bfloat16().float()
    splits, depth = dense.bf16_splits(M, N, K)
    assert splits > 1
    total = torch.zeros((M, N))
    for z in range(splits):
        lo, hi = z * depth, min(K, (z + 1) * depth)
        total += x[:, lo:hi] @ w[lo:hi]
    want = x.double() @ w.double()
    assert (total.double() - want).abs().max().item() <= \
        1e-5 * want.abs().max().item()


def _scratch_csrc(tmp_path, monkeypatch):
    """Point build.py at a copy of csrc/ (and a build dir) in tmp_path."""
    shutil.copytree(build.CSRC, tmp_path / "csrc")
    monkeypatch.setattr(build, "_HERE", tmp_path)
    monkeypatch.setattr(build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return tmp_path / "csrc"


@pytest.mark.parametrize("name", ["dense_fwd", "dense_bwd"])
def test_a_changed_header_changes_the_library_name(tmp_path, monkeypatch,
                                                   name):
    csrc = _scratch_csrc(tmp_path, monkeypatch)
    assert (csrc / "gemm_f32.cuh").is_file()
    before = build._target(name)
    assert build._target(name) == before          # deterministic
    header = csrc / "gemm_f32.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = build._target(name)
    assert after != before and after.parent == before.parent


def test_a_new_header_changes_the_library_name(tmp_path, monkeypatch):
    csrc = _scratch_csrc(tmp_path, monkeypatch)
    before = build._target("conv2d")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build._target("conv2d") != before


@pytest.mark.parametrize("name,header", [
    ("dense_fwd", "gemm_f32.cuh"), ("dense_bwd", "gemm_f32.cuh"),
    ("dense_fwd", "cp_async.cuh"), ("flash_attention", "cp_async.cuh")])
def test_sources_include_the_shared_header(name, header):
    text = (build._HERE / build.SOURCES[name]).read_text()
    assert f'#include "{header}"' in text
    assert (build.CSRC / header).is_file()
