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
    ("bfloat16", 5, 72, 70), ("float32", 37, 100, 77),
    # f32 split-K: the case7 hidden layer (8 slices), K not a multiple of
    # slices x 16 (7 slices of 144 over 1000), K not a multiple of 4 (the
    # element-by-element loads), N = 10 (14 slices, one tile)
    ("float32", 64, 2000, 2000), ("float32", 37, 1000, 77),
    ("float32", 64, 1002, 200), ("float32", 64, 2000, 10)])
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
@pytest.mark.parametrize("M", [1, 4, 16])
@pytest.mark.parametrize("K,N,relu", [
    (4096, 512, False), (4096, 11008, False), (36864, 4608, False),
    # ragged: N off the 64-column tile, K off the 64-deep step, N or K
    # not a multiple of 8 (the element-by-element loads)
    (4096, 520, True), (1000, 77, True), (4099, 130, True)])
def test_dense_bf16_split_kernel_matches_plain_and_reruns(M, K, N, relu):
    """K1's bf16 decode instance (split-K weight stream) at Yi-6B's and
    Gemma-2's split shapes: one bf16 rounding of the output from the plain
    version, one launch a call, identical bits on a rerun."""
    _card()
    gen = torch.Generator("cuda").manual_seed(8)
    x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((K, N), generator=gen, device="cuda")
         / K ** 0.5).bfloat16()
    b = torch.randn((N,), generator=gen, device="cuda") if relu else None
    act = "relu" if relu else "none"
    before = dense.dense_cuda.launches
    got = dense.dense_cuda(x, w, b, activation=act)
    again = dense.dense_cuda(x, w, b, activation=act)
    want = ref.dense_ref(x, w, b, activation=act)
    torch.cuda.synchronize()
    assert dense.dense_cuda.launches == before + 2
    assert dense.bf16_splits(M, N, K)[0] > 1
    tol = 1e-2 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [17, 24, 33, 63, 64, 65, 129])
@pytest.mark.parametrize("K,N,relu", [
    (4096, 512, False), (11008, 4096, True),
    # ragged: N off the 128-column tile, K off the 32-deep step, N or K
    # not a multiple of 8 (the element-by-element loads)
    (4096, 520, True), (1000, 77, True), (4099, 130, False),
    (72, 70, True)])
def test_dense_bf16_prefill_kernel_matches_plain_and_reruns(M, K, N, relu):
    """K1's bf16 prefill instance (the tile GEMM; 64-row tiles to M = 64,
    128-row beyond, split over K where its tiles leave SMs idle): one bf16
    rounding of the output from the plain version, one launch a call,
    identical bits on a rerun."""
    _card()
    gen = torch.Generator("cuda").manual_seed(10)
    x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((K, N), generator=gen, device="cuda")
         / K ** 0.5).bfloat16()
    b = torch.randn((N,), generator=gen, device="cuda") if relu else None
    act = "relu" if relu else "none"
    before = dense.dense_cuda.launches
    got = dense.dense_cuda(x, w, b, activation=act)
    again = dense.dense_cuda(x, w, b, activation=act)
    want = ref.dense_ref(x, w, b, activation=act)
    torch.cuda.synchronize()
    assert dense.dense_cuda.launches == before + 2
    tol = 1e-2 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(512, 4608, 4096), (512, 36864, 4608),
                                   (1000, 4608, 2048)])
def test_dense_bf16_prefill_gemma_shapes_match_plain_and_rerun(M, K, N):
    """The compute-bound regime at Gemma-2's widths (128-row tiles; 4608
    -> 4096 at M = 512 splits K in two), with bias and relu."""
    _card()
    gen = torch.Generator("cuda").manual_seed(11)
    x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((K, N), generator=gen, device="cuda")
         / K ** 0.5).bfloat16()
    b = torch.randn((N,), generator=gen, device="cuda")
    got = dense.dense_cuda(x, w, b, activation="relu")
    again = dense.dense_cuda(x, w, b, activation="relu")
    want = ref.dense_ref(x, w, b, activation="relu")
    torch.cuda.synchronize()
    tol = 1e-2 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(got, again)


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


# ----------------------------------------------------------------------
# K2-K8: the training kernels, f32, against their plain versions
# ----------------------------------------------------------------------
GRAD_TOL = 1e-4      # x max(max|ref|, 1): the reference's gradient gate


@pytest.fixture(autouse=True)
def _exact_f32(monkeypatch):
    """The plain versions run cuBLAS/cuDNN on the card: keep them in full
    f32, since TF32 products alone miss the 1e-4 gradient gate."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def _gen(seed):
    return torch.Generator("cuda").manual_seed(seed)


def _randn(gen, shape):
    return torch.randn(shape, generator=gen, device="cuda")


def _close(got, want, grad):
    got = torch.cat([t.reshape(-1) for t in got]) if isinstance(
        got, tuple) else got
    want = torch.cat([t.reshape(-1) for t in want]) if isinstance(
        want, tuple) else want
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    tol = GRAD_TOL * max(scale, 1.0) if grad else 1e-5 * scale
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("M,Din,Dout,relu", [
    (64, 192, 2000, True), (64, 2000, 10, False), (37, 100, 77, True),
    # K2 split over Dout: the case7 hidden layer, Dout not a multiple of
    # slices x 16, Dout not a multiple of 4, one 10-wide tile of 14 slices
    (64, 2000, 2000, True), (37, 77, 1000, True), (64, 200, 1002, True),
    (64, 10, 2000, False)])
def test_dense_backward_kernels_match_plain(M, Din, Dout, relu):
    _card()
    from repro_torch.kernels import dense as dn
    gen = _gen(2)
    x, w = _randn(gen, (M, Din)), _randn(gen, (Din, Dout))
    g = _randn(gen, (M, Dout))
    out = torch.relu(_randn(gen, (M, Dout))) if relu else None
    before = (dn.dense_dx_cuda.launches, dn.dense_dwdb_cuda.launches)
    _close(dn.dense_dx_cuda(g, w, out), ref.dense_dx_ref(g, w, out), True)
    _close(dn.dense_dwdb_cuda(x, g, out), ref.dense_dwdb_ref(x, g, out),
           True)
    assert (dn.dense_dx_cuda.launches, dn.dense_dwdb_cuda.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("M,Din,Dout", [(64, 2000, 2000), (37, 77, 1000),
                                        (64, 192, 2000)])
def test_split_dense_kernels_rerun_bit_for_bit(M, Din, Dout):
    """K1 f32 and K2 add their split partials in slice order, without
    atomics: a rerun gives identical bits."""
    _card()
    from repro_torch.kernels import dense as dn
    gen = _gen(7)
    x, w = _randn(gen, (M, Din)), _randn(gen, (Din, Dout))
    b, g = _randn(gen, (Dout,)), _randn(gen, (M, Dout))
    out = torch.relu(_randn(gen, (M, Dout)))
    fwd = [dn.dense_cuda(x, w, b, activation="relu") for _ in range(2)]
    dx = [dn.dense_dx_cuda(g, w, out) for _ in range(2)]
    torch.cuda.synchronize()
    assert dn.dense_splits(M, Dout, Din) > 1 or dn.dense_splits(
        M, Din, Dout) > 1
    assert torch.equal(fwd[0], fwd[1]) and torch.equal(dx[0], dx[1])


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,Cin,Cout,k,padding", [
    (64, 32, 32, 3, 12, 3, "SAME"), (3, 9, 7, 3, 5, 2, "SAME"),
    (3, 9, 7, 3, 5, 4, "SAME"), (2, 9, 7, 4, 20, 7, "SAME"),
    (3, 9, 7, 4, 20, 3, "VALID")])
def test_conv_kernels_match_plain(B, H, W, Cin, Cout, k, padding):
    _card()
    from repro_torch.kernels import conv2d as cv
    gen = _gen(3)
    x, w = _randn(gen, (B, H, W, Cin)), _randn(gen, (k, k, Cin, Cout))
    b = _randn(gen, (Cout,))
    out = cv.conv2d_cuda(x, w, b, padding=padding, activation="relu")
    _close(out, ref.conv2d_fused_ref(x, w, b, padding=padding,
                                      activation="relu"), False)
    g = _randn(gen, tuple(out.shape))
    _close(cv.conv2d_dx_cuda(g, w, x.shape, padding, out),
           ref.conv2d_dx_ref(g, w, x.shape, padding, out), True)
    dw = cv.conv2d_dw_cuda(x, g, w.shape, padding, out)
    _close(dw, ref.conv2d_dw_ref(x, g, w.shape, padding, out), True)
    again = cv.conv2d_dw_cuda(x, g, w.shape, padding, out)
    assert torch.equal(dw[0], again[0]) and torch.equal(dw[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,Cin,Cout,k,padding", [
    # every case7 shape at B = 64, then the ragged cases: odd B, Cin 3,
    # k = 2/4/7, VALID, tiles clipped at the edges, several images a tile
    (64, 32, 32, 3, 12, 3, "SAME"), (64, 16, 16, 12, 12, 3, "SAME"),
    (64, 8, 8, 12, 12, 3, "SAME"), (64, 4, 4, 12, 12, 3, "SAME"),
    (3, 9, 7, 3, 5, 2, "SAME"), (3, 9, 7, 3, 5, 4, "SAME"),
    (3, 9, 7, 3, 5, 7, "SAME"), (3, 9, 7, 4, 20, 3, "VALID"),
    (1, 8, 8, 12, 12, 7, "VALID"), (5, 6, 6, 12, 12, 7, "SAME"),
    (7, 5, 300, 3, 16, 5, "SAME"),
    # wide Cin: tiles of 145 KB and 219 KB of shared memory (past 48 KB)
    (1, 8, 8, 2048, 16, 3, "SAME"), (1, 6, 6, 1000, 8, 7, "SAME")])
def test_conv_dw_kernel_matches_plain_and_reruns(B, H, W, Cin, Cout, k,
                                                 padding):
    """K6 (tiles of output pixels, fixed-order sums): within the gradient
    gate of its plain version, with and without the relu mask, one launch a
    call, identical bits on a rerun."""
    _card()
    from repro_torch.kernels import conv2d as cv
    gen = _gen(12)
    Ho, Wo = (H, W) if padding == "SAME" else (H - k + 1, W - k + 1)
    x = _randn(gen, (B, H, W, Cin))
    g = _randn(gen, (B, Ho, Wo, Cout))
    out = torch.relu(_randn(gen, (B, Ho, Wo, Cout)))
    ws = (k, k, Cin, Cout)
    for mask in (out, None):
        before = cv.conv2d_dw_cuda.launches
        got = cv.conv2d_dw_cuda(x, g, ws, padding, mask)
        again = cv.conv2d_dw_cuda(x, g, ws, padding, mask)
        assert cv.conv2d_dw_cuda.launches == before + 2
        _close(got, ref.conv2d_dw_ref(x, g, ws, padding, mask), True)
        assert torch.equal(got[0], again[0]) and torch.equal(got[1],
                                                             again[1])


@pytest.mark.cuda
def test_conv_dw_tile_chooser_counts_the_kernels_bytes():
    """conv2d.dw_smem (which sizes K6's tiles) equals the kernel's own
    count of a pass-1 block's shared memory, DwPlan::smem, at every tile
    the chooser picks for the case7, ragged and wide shapes and at tiles
    of 1-256 pixels."""
    _card()
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels import conv2d as cv
    fn = build.load("conv2d").conv2d_dw_smem
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_longlong
    shapes = [(64, 32, 32, 3, 12, 3), (64, 16, 16, 12, 12, 3),
              (64, 4, 4, 12, 12, 3), (3, 9, 7, 3, 5, 7), (3, 9, 7, 4, 20, 3),
              (2, 56, 56, 512, 512, 3), (1, 6, 6, 1000, 8, 7),
              (1, 8, 8, 2048, 16, 3), (7, 3, 3, 33, 17, 1)]
    for B, H, W, Cin, Cout, k in shapes:
        tiles = {cv.dw_tile(B, H, W, Cin, Cout, k, k), (1, 1, 1), (1, 1, W),
                 (1, 2, W), (B, H, W), (1, H, W)}
        for tile in tiles:
            assert fn(Cin, Cout, k, k, *tile) == cv.dw_smem(tile, Cin, Cout,
                                                            k, k), tile


# K4/K5 at every case7 shape, the ragged cases (odd B, Cin 3, k = 2/4/7,
# VALID, tiles clipped at the edges, several images a tile, tiles of 6
# pixels) and wide ones: Cin in chunks through the ring (K4 at Cin 2048 and
# 1000; K5's 2048-wide output in column tiles), Cout past 16 (column tiles)
# and a 25 x 25 filter in tap chunks
CONV_TILE_SHAPES = [
    (64, 32, 32, 3, 12, 3, "SAME"), (64, 16, 16, 12, 12, 3, "SAME"),
    (64, 8, 8, 12, 12, 3, "SAME"), (64, 4, 4, 12, 12, 3, "SAME"),
    (3, 9, 7, 3, 5, 2, "SAME"), (3, 9, 7, 3, 5, 4, "SAME"),
    (3, 9, 7, 3, 5, 7, "SAME"), (2, 9, 7, 4, 20, 7, "SAME"),
    (3, 9, 7, 4, 20, 3, "VALID"), (1, 8, 8, 12, 12, 7, "VALID"),
    (5, 6, 6, 12, 12, 7, "SAME"), (140, 3, 3, 4, 5, 3, "SAME"),
    (7, 5, 300, 3, 16, 5, "SAME"),
    (1, 8, 8, 2048, 16, 3, "SAME"), (2, 9, 7, 4, 300, 3, "SAME"),
    (1, 6, 6, 1000, 8, 7, "SAME"), (1, 30, 30, 8, 16, 25, "SAME")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,Cin,Cout,k,padding", CONV_TILE_SHAPES)
def test_conv_fwd_and_dx_kernels_match_plain_and_rerun(B, H, W, Cin, Cout,
                                                       k, padding):
    """K4 (with bias and relu, and without either) and K5 (with the relu
    mask and without): within the forward and gradient gates of their plain
    versions, one launch a call, identical bits on a rerun."""
    _card()
    from repro_torch.kernels import conv2d as cv
    gen = _gen(13)
    x = _randn(gen, (B, H, W, Cin))
    w = _randn(gen, (k, k, Cin, Cout)) / (k * k * Cin) ** 0.5
    b = _randn(gen, (Cout,))
    for bias, act in ((b, "relu"), (None, "none")):
        before = cv.conv2d_cuda.launches
        got = cv.conv2d_cuda(x, w, bias, padding=padding, activation=act)
        again = cv.conv2d_cuda(x, w, bias, padding=padding, activation=act)
        assert cv.conv2d_cuda.launches == before + 2
        _close(got, ref.conv2d_fused_ref(x, w, bias, padding=padding,
                                          activation=act), False)
        assert torch.equal(got, again)
    g = _randn(gen, tuple(got.shape))
    out = torch.relu(_randn(gen, tuple(got.shape)))
    for mask in (out, None):
        before = cv.conv2d_dx_cuda.launches
        dx = cv.conv2d_dx_cuda(g, w, x.shape, padding, mask)
        again = cv.conv2d_dx_cuda(g, w, x.shape, padding, mask)
        assert cv.conv2d_dx_cuda.launches == before + 2
        _close(dx, ref.conv2d_dx_ref(g, w, x.shape, padding, mask), True)
        assert torch.equal(dx, again)


@pytest.mark.cuda
def test_conv_tile_chooser_counts_the_kernels_bytes():
    """conv2d.conv_smem (which sizes K4/K5's tiles and chunks) equals the
    kernel's own count of a block's shared memory, ConvPlan::smem, at every
    (tile, chunk, taps) the chooser picks for the case7, ragged and wide
    shapes and at other tiles, chunks and tap counts."""
    _card()
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels import conv2d as cv
    fn = build.load("conv2d").conv2d_tile_smem
    fn.argtypes = [ctypes.c_int] * 10
    fn.restype = ctypes.c_longlong
    for B, H, W, Cin, Cout, k, pad in CONV_TILE_SHAPES:
        for flip in (False, True):
            ci, co = (Cout, Cin) if flip else (Cin, Cout)
            picked = cv.conv_tile(B, H, W, ci, co, k, k, flip)
            plans = {picked, (1, 1, 1, 1, 1), (1, 1, 4, ci, k * k),
                     (1, 1, W, max(1, ci // 2), k), (B, H, W, 1, 1)}
            for tb, th, tw, chunk, taps in plans:
                if tb * th * tw > 256:
                    continue
                assert fn(ci, co, k, k, tb, th, tw, chunk, taps, flip) == \
                    cv.conv_smem((tb, th, tw), chunk, taps, ci, co, k, k,
                                 flip), (picked, tb, th, tw, chunk, taps)


@pytest.mark.cuda
@pytest.mark.parametrize("M,Din,Dout", [
    # the case7 shapes; ragged rows, Din and Dout (Din or Dout not a
    # multiple of 4: the element-by-element loads; Din % 64 == 0, so the
    # row of ones is a tile of its own); a long reduction on a small
    # output (32 slices), and one on a 64 x 64 output; the 128 x 64
    # register tile (528 64 x 64 tiles or more) with ragged Din and Dout,
    # and at its threshold
    (64, 192, 2000), (64, 2000, 2000), (64, 2000, 10),
    (37, 100, 77), (5, 3, 130), (64, 192, 70), (37, 77, 1000),
    (64, 200, 1002), (64, 10, 2000), (3, 1001, 77), (64, 64, 64),
    (4096, 77, 10), (1000, 64, 64), (70, 2001, 2003), (64, 1663, 1344)])
def test_dense_dwdb_kernel_matches_plain_and_reruns(M, Din, Dout):
    """K3 ([x, 1]^T (g masked) on the split-K product, db its last row):
    within the gradient gate of its plain version with and without the relu
    mask, one launch a call, identical bits on a rerun."""
    _card()
    from repro_torch.kernels import dense as dn
    gen = _gen(14)
    x, g = _randn(gen, (M, Din)), _randn(gen, (M, Dout))
    out = torch.relu(_randn(gen, (M, Dout)))
    for mask in (out, None):
        before = dn.dense_dwdb_cuda.launches
        got = dn.dense_dwdb_cuda(x, g, mask)
        again = dn.dense_dwdb_cuda(x, g, mask)
        assert dn.dense_dwdb_cuda.launches == before + 2
        assert got[0].shape == (Din, Dout) and got[1].shape == (Dout,)
        _close(got, ref.dense_dwdb_ref(x, g, mask), True)
        assert torch.equal(got[0], again[0]) and torch.equal(got[1],
                                                             again[1])
    assert dn.dwdb_splits(M, Din, Dout) > 1 or M <= 128


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ties,window", [
    ((64, 32, 32, 12), False, 2), ((3, 9, 7, 5), False, 2),
    ((2, 8, 8, 12), True, 2),
    ((3, 10, 11, 7), False, 3)])   # window 3, ragged H and W, C % 4 != 0
def test_pool_kernels_match_plain(shape, ties, window):
    _card()
    from repro_torch.kernels import launch
    from repro_torch.kernels import pool2d as pl
    gen = _gen(4)
    x = _randn(gen, shape)
    x = torch.relu(torch.round(x) if ties else x)
    out = pl.max_pool2d_cuda(x, window)
    want = ref.max_pool2d_ref(x, window, window)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    g = _randn(gen, tuple(out.shape))
    want_dx = ref.max_pool2d_bwd_ref(x, out, g, window)
    _close(pl.max_pool2d_bwd_cuda(x, out, g, window), want_dx, True)
    # K8 writes every dx element, the dropped remainder too: a NaN-filled
    # dx comes back equal to the plain version
    dx = torch.full_like(x, float("nan"))
    plan = pl.bwd_plan(*shape, window)
    launch.run("pool2d", "max_pool2d_bwd_f32", x.device, (x, out, g, dx),
               (*shape, window, plan.lanes, plan.threads, plan.blocks))
    torch.cuda.synchronize()
    assert torch.equal(dx, want_dx)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [12, 7])
@pytest.mark.parametrize("window", [2, 3])
def test_pool_fwd_kernel_writes_every_output_element(window, C):
    """K7 through its plan into a NaN-filled out: every output element
    comes back equal to the plain version (C = 12: 16-byte lanes; 7: a
    channel a thread; ragged H and W); a plan a block short or a block
    over is refused; the wrapper counts one launch."""
    _card()
    from repro_torch.kernels import launch
    from repro_torch.kernels import pool2d as pl
    shape = (5, 13, 11, C)
    x = torch.relu(_randn(_gen(10), shape))
    want = ref.max_pool2d_ref(x, window, window)
    out = torch.full_like(want, float("nan"))
    plan = pl.fwd_plan(*shape, window)
    assert plan.lanes == (4 if C % 4 == 0 else 1)
    launch.run("pool2d", "max_pool2d_fwd_f32", x.device, (x, out),
               (*shape, window, plan.lanes, plan.threads, plan.blocks))
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    for blocks in (plan.blocks - 1, plan.blocks + 1):
        with pytest.raises(RuntimeError, match="launch failed"):
            launch.run("pool2d", "max_pool2d_fwd_f32", x.device, (x, out),
                       (*shape, window, plan.lanes, plan.threads, blocks))
    before = pl.max_pool2d_cuda.launches
    assert torch.equal(pl.max_pool2d_cuda(x, window), want)
    assert pl.max_pool2d_cuda.launches == before + 1


@pytest.mark.cuda
def test_cnn_step_on_card_matches_cpu():
    """One Table-2 case1 gradient on the card and on the CPU from the same
    params and batch."""
    _card()
    from repro_torch import weights
    from repro_torch.core.bpt_trainer import value_and_grad
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.synthetic import image_dataset
    from repro_torch.models import cnn
    cfg = cnn.make_case("case1")
    tree = weights.params_to_numpy(cnn.init_cnn(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    xs, ys = image_dataset(4, seed=1)
    out = {}
    for dev in ("cuda", "cpu"):
        params = weights.params_from_numpy(tree, cfg, dev)
        batch = {"images": torch.as_tensor(xs, device=dev),
                 "labels": torch.as_tensor(ys, device=dev)}
        (loss, _), grads = value_and_grad(
            lambda p, bt: (cnn.cnn_loss(p, bt, cfg), {}), params, batch)
        out[dev] = [loss.cpu()] + [t.cpu() for t in tree_leaves(grads)]
    assert abs(out["cuda"][0].item() - out["cpu"][0].item()) <= \
        1e-5 * abs(out["cpu"][0].item())
    for a, e in zip(out["cuda"][1:], out["cpu"][1:], strict=True):
        scale = max(e.abs().max().item(), 1.0)
        assert (a - e).abs().max().item() <= GRAD_TOL * scale


@pytest.mark.cuda
def test_strided_conv_on_card_raises():
    """The conv kernels are stride-1: a strided call on a CUDA tensor
    raises instead of running anything else."""
    _card()
    x = torch.zeros((1, 8, 8, 3), device="cuda")
    w = torch.zeros((3, 3, 3, 4), device="cuda")
    with pytest.raises(NotImplementedError, match="stride"):
        ops.conv2d(x, w, stride=2)


# ----------------------------------------------------------------------
# K9 and K10: RMSNorm and flash attention, against their plain versions
# ----------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows,d", [(4, 4608), (300, 4096), (7, 3072),
                                    (5, 4095), (3, 13), (1, 1),
                                    (3001, 4095), (5000, 4608),
                                    # Qwen3's q/k norms, d = head_dim:
                                    # decode (4 slots x 32 q heads) and a
                                    # 2048-token prefill's 4 k heads
                                    (128, 128), (8192, 128)])
def test_rmsnorm_kernel_matches_plain(rows, d, dtype):
    """Decode and prefill rows at the LM widths (the row kernel: a block a
    row up to 132 rows, several rows a block beyond), and ragged rows
    whose starts are not 16-byte aligned (d = 4095, 13: the chunked
    kernel); identical bits on a rerun."""
    _card()
    from repro_torch.kernels import rmsnorm as rms
    gen = _gen(5)
    x = _randn(gen, (rows, d)).to(getattr(torch, dtype))
    scale = _randn(gen, (d,)) * 0.1 + 1.0
    before = rms.rmsnorm_cuda.launches
    got = ops.rmsnorm(x, scale)
    want = ref.rmsnorm_ref(x, scale)
    torch.cuda.synchronize()
    assert rms.rmsnorm_cuda.launches == before + 1
    assert got.dtype == x.dtype
    # bf16: one rounding of the output; f32: sums in another order
    tol = (1e-5 if dtype == "float32" else 1e-2) * want.float().abs().max()
    assert (got.float() - want.float()).abs().max().item() <= tol.item()
    assert torch.equal(got, ops.rmsnorm(x, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,causal,window,softcap", [
    (1, 8, 4, 300, 300, 128, True, 0, 50.0),      # Gemma-2 heads, global
    (1, 8, 4, 333, 333, 128, True, 100, 50.0),    # ragged, windowed
    (2, 4, 1, 130, 130, 96, True, 0, 0.0),        # Phi-3 head_dim, MQA
    (1, 4, 4, 64, 90, 32, False, 16, 0.0),        # Sk > Sq, not causal
    (1, 4, 2, 300, 200, 16, True, 0, 0.0),        # fully masked rows
    (1, 2, 2, 40, 40, 256, True, 0, 30.0),        # the widest head
])
def test_flash_attention_kernel_matches_plain(B, H, KH, Sq, Sk, D, causal,
                                              window, softcap, dtype):
    _card()
    from repro_torch.kernels import flash_attention as fa
    gen = _gen(6)
    tdt = getattr(torch, dtype)
    q = _randn(gen, (B, H, Sq, D)).to(tdt)
    k = _randn(gen, (B, KH, Sk, D)).to(tdt)
    v = _randn(gen, (B, KH, Sk, D)).to(tdt)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = fa.flash_attention_cuda.launches
    got = fa.flash_attention_cuda(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + 1
    # the reference's K10 tolerances (tests/test_kernels.py)
    atol, rtol = (1e-4, 1e-3) if dtype == "float32" else (8e-2, 2e-2)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,window,softcap", [
    (1, 8, 4, 300, 300, 128, 0, 50.0), (1, 8, 4, 333, 333, 128, 100, 50.0),
    (1, 4, 2, 300, 200, 16, 0, 0.0), (1, 2, 2, 40, 40, 256, 0, 30.0)])
def test_flash_attention_bf16_reruns_bit_for_bit(B, H, KH, Sq, Sk, D,
                                                 window, softcap):
    """K10's bf16 instance (tensor-core products, fixed summation order):
    identical bits on a rerun."""
    _card()
    from repro_torch.kernels import flash_attention as fa
    gen = _gen(9)
    q, k, v = (_randn(gen, (B, n, S, D)).bfloat16()
               for n, S in ((H, Sq), (KH, Sk), (KH, Sk)))
    kw = dict(causal=True, window=window, softcap=softcap)
    first = fa.flash_attention_cuda(q, k, v, **kw)
    second = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_flash_attention_gradient_on_card_raises():
    _card()
    q = torch.zeros((1, 8, 2, 16), device="cuda", requires_grad=True)
    k = torch.zeros((1, 8, 1, 16), device="cuda")
    with pytest.raises(NotImplementedError, match="backward"):
        ops.flash_attention(q, k, k)


# (B, H, KH, Sq, Sk, D, window, softcap, offset): K10's f32 instance at
# every head-dim instance the models reach (64, 96, 128) and the widest
# (256), causal Sq > Sk (fully masked rows), D % 4 != 0 and tensors off 16
# bytes (``offset`` floats: the 4-byte copies)
FLASH_F32 = [
    (1, 8, 4, 300, 300, 64, 0, 50.0, 0), (2, 4, 2, 333, 333, 96, 100, 50.0, 0),
    (1, 8, 4, 300, 300, 128, 128, 50.0, 0), (1, 2, 2, 130, 130, 256, 0, 30.0, 0),
    (1, 4, 2, 300, 200, 64, 0, 0.0, 0), (1, 4, 2, 300, 200, 128, 0, 50.0, 0),
    (1, 4, 2, 77, 77, 13, 0, 0.0, 0), (1, 4, 2, 150, 150, 128, 40, 50.0, 1)]


def _f32_qkv(B, H, KH, Sq, Sk, D, softcap, offset, seed):
    """q (x 8 where a soft-cap is on, so it acts), k, v: contiguous f32 on
    the card, each starting ``offset`` floats into its buffer."""
    gen = _gen(seed)
    out = []
    for n, S, scale in ((H, Sq, 8.0 if softcap else 1.0), (KH, Sk, 1.0),
                        (KH, Sk, 1.0)):
        buf = _randn(gen, (offset + B * n * S * D,)) * scale
        out.append(buf[offset:].view(B, n, S, D))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,window,softcap,offset", FLASH_F32)
def test_flash_attention_f32_kernel_matches_plain(B, H, KH, Sq, Sk, D,
                                                  window, softcap, offset):
    """K10's f32 instance (3xTF32 products) at the f32 gate, atol 1e-4 and
    rtol 1e-3, against its plain version."""
    _card()
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _f32_qkv(B, H, KH, Sq, Sk, D, softcap, offset, 11)
    assert q.is_contiguous() and (q.data_ptr() % 16 != 0) == (offset != 0)
    kw = dict(causal=True, window=window, softcap=softcap)
    before = fa.flash_attention_cuda.launches
    got = fa.flash_attention_cuda(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,window,softcap,offset", FLASH_F32)
def test_flash_attention_f32_reruns_bit_for_bit(B, H, KH, Sq, Sk, D, window,
                                                softcap, offset):
    """K10's f32 instance sums in a fixed order: identical bits on a
    rerun."""
    _card()
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _f32_qkv(B, H, KH, Sq, Sk, D, softcap, offset, 12)
    kw = dict(causal=True, window=window, softcap=softcap)
    first = fa.flash_attention_cuda(q, k, v, **kw)
    second = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# ----------------------------------------------------------------------
# The LM's training kernels: K2 and K3 in bf16, K9's backward
# ----------------------------------------------------------------------
def _bf16_grad_gates(got, want, one_rounding):
    """dx within one bf16 rounding of the plain value (1e-2 x max|ref|,
    K1 bf16's gate); f32 gradients within GRAD_TOL x max(max|ref|, 1)."""
    torch.cuda.synchronize()
    scale = want.float().abs().max().item()
    tol = 1e-2 * scale if one_rounding else GRAD_TOL * max(scale, 1.0)
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("M,Din,Dout,relu", [
    # Phi-3-mini's and Yi-6B's projections at a B 8 x S 128 step
    (1024, 3072, 8192, False), (1024, 8192, 3072, False),
    (1024, 4096, 512, False),
    # ragged M, the relu mask, and shapes off 8 (element-by-element loads)
    (24, 4096, 4096, True), (1000, 3072, 3072, True), (37, 100, 77, True),
    (5, 13, 9, False)])
def test_dense_bf16_backward_kernels_match_plain_and_rerun(M, Din, Dout,
                                                           relu):
    """K2's and K3's bf16 instances: dx within one bf16 rounding of the
    plain version, dw and db at the f32 gradient gate, one launch a call,
    identical bits on a rerun."""
    _card()
    from repro_torch.kernels import dense as dn
    gen = _gen(21)
    x = _randn(gen, (M, Din)).bfloat16()
    w = (_randn(gen, (Din, Dout)) / Din ** 0.5).bfloat16()
    g = _randn(gen, (M, Dout)).bfloat16()
    out = torch.relu(_randn(gen, (M, Dout))).bfloat16() if relu else None
    before = (dn.dense_dx_cuda.launches, dn.dense_dwdb_cuda.launches)
    dx = dn.dense_dx_cuda(g, w, out)
    dw, db = dn.dense_dwdb_cuda(x, g, out)
    assert (dn.dense_dx_cuda.launches, dn.dense_dwdb_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    _bf16_grad_gates(dx, ref.dense_dx_ref(g, w, out), True)
    want_dw, want_db = ref.dense_dwdb_ref(x, g, out)
    _bf16_grad_gates(dw, want_dw, False)
    _bf16_grad_gates(db, want_db, False)
    assert torch.equal(dx, dn.dense_dx_cuda(g, w, out))
    again = dn.dense_dwdb_cuda(x, g, out)
    assert torch.equal(dw, again[0]) and torch.equal(db, again[1])


def _ints(gen, shape):
    """Small integers in bf16: products and their sums are exact in f32,
    so a wrong operand layout cannot hide inside a tolerance."""
    return torch.randint(-2, 3, shape, generator=gen,
                         device="cuda").bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_dense_bwd_wgmma_one_tile_is_exact(kernel):
    """One output tile of the TMA + wgmma route on exact integers: K3's
    MN-major operands (x read [k][m], g read [k][n], 128-byte swizzled,
    the transpose bits set) and K2's K-major ones give torch.matmul's
    product bit for bit (K3's dw in f32; K2's dx rounded to bf16 from the
    exact sum, as the plain version)."""
    _card()
    from repro_torch.kernels import dense as dn
    gen = _gen(26)
    if kernel == "K3":
        x, g = _ints(gen, (64, 128)), _ints(gen, (64, 128))
        plan = dn.bwd_bf16_plan("K3", 64, 128, 128)
        dw, db = dn.dense_dwdb_cuda(x, g)
        torch.cuda.synchronize()
        assert torch.equal(dw, torch.matmul(x.float().t(), g.float()))
        assert torch.equal(db, g.float().sum(0))
    else:
        g, w = _ints(gen, (128, 64)), _ints(gen, (128, 64))
        plan = dn.bwd_bf16_plan("K2", 128, 128, 64)
        dx = dn.dense_dx_cuda(g, w)
        torch.cuda.synchronize()
        assert torch.equal(dx, torch.matmul(g.float(), w.float().t())
                           .bfloat16())
    assert (plan.route, plan.tiles) == ("wgmma", 1)


@pytest.mark.cuda
@pytest.mark.parametrize("M,Din,Dout", [
    # every tile width with a ragged last tile, ragged M and K
    (1000, 3000, 3080), (24, 1000, 200), (1000, 8200, 1000),
    (24, 3000, 3000)])
def test_dense_bwd_wgmma_ragged_edges_are_exact(M, Din, Dout):
    """Exact integers through both kernels where TMA zero-fills boxes past
    M, Din or Dout and the epilogue stores only what lies inside: dx, f32
    dw and db bit for bit, bf16 dw the f32 dw's cast bit for bit."""
    _card()
    from repro_torch.kernels import dense as dn
    gen = _gen(27)
    x, g, w = (_ints(gen, (M, Din)), _ints(gen, (M, Dout)),
               _ints(gen, (Din, Dout)))
    for kernel in ("K2", "K3"):
        assert dn.bwd_bf16_plan(kernel, M, Din, Dout).route == "wgmma"
    dx = dn.dense_dx_cuda(g, w)
    dw, db = dn.dense_dwdb_cuda(x, g)
    dw16, none = dn.dense_dwdb_cuda(x, g, dw_dtype=torch.bfloat16,
                                    want_db=False)
    torch.cuda.synchronize()
    assert torch.equal(dx, (g.float() @ w.float().t()).bfloat16())
    assert torch.equal(dw, x.float().t() @ g.float())
    assert torch.equal(db, g.float().sum(0))
    assert none is None and torch.equal(dw16, dw.bfloat16())


@pytest.mark.cuda
@pytest.mark.parametrize("Din,Dout", [(3072, 3072), (3072, 8192),
                                      (8192, 3072), (4096, 512)])
def test_dense_bwd_wgmma_phi3_shapes_match_plain_and_rerun(Din, Dout):
    """Phi-3-mini's projections (and Yi-6B's narrowest) at a B 8 x S 128
    step on the wgmma route: dx within one bf16 rounding, f32 dw and db at
    the gradient gate, bf16 dw the f32 dw's cast bit for bit, one launch
    a call, identical bits on a rerun."""
    _card()
    from repro_torch.kernels import dense as dn
    M = 1024
    gen = _gen(28)
    x = _randn(gen, (M, Din)).bfloat16()
    w = (_randn(gen, (Din, Dout)) / Din ** 0.5).bfloat16()
    g = _randn(gen, (M, Dout)).bfloat16()
    for kernel in ("K2", "K3"):
        assert dn.bwd_bf16_plan(kernel, M, Din, Dout).route == "wgmma"
    before = (dn.dense_dx_cuda.launches, dn.dense_dwdb_cuda.launches)
    dx = dn.dense_dx_cuda(g, w)
    dw, db = dn.dense_dwdb_cuda(x, g)
    dw16, _ = dn.dense_dwdb_cuda(x, g, dw_dtype=torch.bfloat16,
                                 want_db=False)
    assert (dn.dense_dx_cuda.launches, dn.dense_dwdb_cuda.launches) == (
        before[0] + 1, before[1] + 2)
    _bf16_grad_gates(dx, ref.dense_dx_ref(g, w), True)
    want_dw, want_db = ref.dense_dwdb_ref(x, g)
    _bf16_grad_gates(dw, want_dw, False)
    _bf16_grad_gates(db, want_db, False)
    assert torch.equal(dw16, dw.bfloat16())
    assert torch.equal(dx, dn.dense_dx_cuda(g, w))
    again = dn.dense_dwdb_cuda(x, g)
    assert torch.equal(dw, again[0]) and torch.equal(db, again[1])


@pytest.mark.cuda
def test_ops_dense_bf16_gradient_on_card_launches_k2_and_k3():
    """A bf16 projection's gradient through ``ops.dense`` launches K2 and
    K3 once each; dw comes back in the f32 weight's dtype through the
    bf16 cast, as the reference's ``_dense_bwd`` and ``astype``."""
    _card()
    from repro_torch.kernels import dense as dn
    gen = _gen(22)
    x = _randn(gen, (2, 12, 64)).bfloat16().requires_grad_()
    w = (_randn(gen, (64, 40)) / 8).requires_grad_()
    g = _randn(gen, (2, 12, 40)).bfloat16()
    before = (dn.dense_dx_cuda.launches, dn.dense_dwdb_cuda.launches)
    dx, dw = torch.autograd.grad(ops.dense(x, w), (x, w), g)
    assert (dn.dense_dx_cuda.launches, dn.dense_dwdb_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    want_dx = ref.dense_dx_ref(g.reshape(-1, 40), w.detach().bfloat16())
    want_dw, _ = ref.dense_dwdb_ref(x.detach().reshape(-1, 64),
                                    g.reshape(-1, 40))
    _bf16_grad_gates(dx.reshape(-1, 64), want_dx, True)
    _bf16_grad_gates(dw, want_dw, True)   # rounded to bf16 on the way


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows,d", [(1024, 3072), (1024, 4608), (7, 4096),
                                    (133, 1000), (3, 13), (1, 64),
                                    (5, 12032), (9, 6150), (4096, 128)])
def test_rmsnorm_backward_kernel_matches_plain_and_reruns(rows, d, dtype):
    """K9's backward: dx within one bf16 rounding (bf16) or at the f32
    gradient gate, dscale at the gradient gate, one launch a call (its
    two passes where the rows take more than one block), identical bits
    on a rerun."""
    _card()
    from repro_torch.kernels import rmsnorm as rms
    gen = _gen(23)
    tdt = getattr(torch, dtype)
    x = _randn(gen, (rows, d)).to(tdt)
    scale = _randn(gen, (d,)) * 0.1 + 1.0
    g = _randn(gen, (rows, d)).to(tdt)
    before = rms.rmsnorm_bwd_cuda.launches
    dx, ds = rms.rmsnorm_bwd_cuda(x, scale, g)
    assert rms.rmsnorm_bwd_cuda.launches == before + 1
    assert dx.dtype == tdt and ds.dtype == torch.float32
    want_dx, want_ds = ref.rmsnorm_bwd_ref(x, scale, g)
    _bf16_grad_gates(dx, want_dx, dtype == "bfloat16")
    _bf16_grad_gates(ds, want_ds, False)
    again = rms.rmsnorm_bwd_cuda(x, scale, g)
    assert torch.equal(dx, again[0]) and torch.equal(ds, again[1])


@pytest.mark.cuda
def test_ops_rmsnorm_gradient_on_card_launches_the_backward():
    """A norm's gradient through ``ops.rmsnorm`` launches K9 forward and
    K9's backward once each; dscale reaches the f32 scale."""
    _card()
    from repro_torch.kernels import rmsnorm as rms
    gen = _gen(24)
    x = _randn(gen, (2, 9, 256)).bfloat16().requires_grad_()
    scale = (_randn(gen, (256,)) * 0.1 + 1.0).requires_grad_()
    g = _randn(gen, (2, 9, 256)).bfloat16()
    before = (rms.rmsnorm_cuda.launches, rms.rmsnorm_bwd_cuda.launches)
    dx, ds = torch.autograd.grad(ops.rmsnorm(x, scale), (x, scale), g)
    assert (rms.rmsnorm_cuda.launches, rms.rmsnorm_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    want_dx, want_ds = ref.rmsnorm_bwd_ref(x.detach().reshape(-1, 256),
                                           scale.detach(), g.reshape(-1, 256))
    _bf16_grad_gates(dx.reshape(-1, 256), want_dx, True)
    _bf16_grad_gates(ds, want_ds, False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_rmsnorm_backward_takes_unaligned_rows(dtype):
    """x and g starting off 16 bytes: K9's backward moves single
    elements instead of 16-byte vectors, at the same gates."""
    _card()
    from repro_torch.kernels import rmsnorm as rms
    gen = _gen(25)
    tdt = getattr(torch, dtype)
    rows, d = 300, 3072
    x = _randn(gen, (rows * d + 1,)).to(tdt)[1:].view(rows, d)
    g = _randn(gen, (rows * d + 1,)).to(tdt)[1:].view(rows, d)
    scale = _randn(gen, (d,)) * 0.1 + 1.0
    assert x.data_ptr() % 16
    dx, ds = rms.rmsnorm_bwd_cuda(x, scale, g)
    want_dx, want_ds = ref.rmsnorm_bwd_ref(x, scale, g)
    _bf16_grad_gates(dx, want_dx, dtype == "bfloat16")
    _bf16_grad_gates(ds, want_ds, False)
    again = rms.rmsnorm_bwd_cuda(x, scale, g)
    assert torch.equal(dx, again[0]) and torch.equal(ds, again[1])


# ----------------------------------------------------------------------
# The MoE layer: library products and index ops around K1/K9 models
# ----------------------------------------------------------------------
def _moe_case(dtype, E=16, k=4, d=256, f=128, B=3, S=40):
    from repro_torch.core.types import ModelConfig
    cfg = ModelConfig(name="moe-card", arch_type="moe", num_layers=1,
                      d_model=d, num_heads=4, num_kv_heads=2, head_dim=64,
                      d_ff=0, num_experts=E, top_k=k, expert_d_ff=f)
    gen = torch.Generator("cpu").manual_seed(31)
    params = {"router": {"w": torch.randn((d, E), generator=gen) * 0.2},
              "wi": torch.randn((E, d, f), generator=gen) / d ** 0.5,
              "wg": torch.randn((E, d, f), generator=gen) / d ** 0.5,
              "wo": torch.randn((E, f, d), generator=gen) / f ** 0.5}
    x = torch.randn((B, S, d), generator=gen).to(getattr(torch, dtype))
    return cfg, params, x


@pytest.mark.cuda
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.5])
def test_moe_layer_on_card_matches_the_cpu_path(cf):
    """f32 with TF32 off: the routing (top_e, keep, slot) equal to the CPU
    path's exactly, the output and aux within f32 sums in another order;
    the bf16 forward reruns bit for bit and stays on the card."""
    _card()
    from repro_torch.models import moe
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg, params, x = _moe_case("float32")
        card = {k: v.cuda() for k, v in params.items() if k != "router"}
        card["router"] = {"w": params["router"]["w"].cuda()}
        with torch.no_grad():
            r_cpu = moe.route(params, x, cfg, cf)
            r_card = moe.route(card, x.cuda(), cfg, cf)
            out_cpu, aux_cpu = moe.moe_layer(params, x, cfg, cf)
            out, aux = moe.moe_layer(card, x.cuda(), cfg, cf)
        for key in ("top_e", "keep", "slot"):
            assert torch.equal(r_card[key].cpu(), r_cpu[key]), key
        assert out.device.type == "cuda"
        torch.testing.assert_close(out.cpu(), out_cpu, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(aux.cpu(), aux_cpu, atol=0, rtol=1e-6)
        cfg, params, x = _moe_case("bfloat16")
        card = {"router": {"w": params["router"]["w"].cuda().bfloat16()},
                **{k: params[k].cuda().bfloat16()
                   for k in ("wi", "wg", "wo")}}
        with torch.no_grad():
            a, _ = moe.moe_layer(card, x.cuda(), cfg, cf)
            b, _ = moe.moe_layer(card, x.cuda(), cfg, cf)
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _multi_trainer(name, m, devices=None, mesh="", family=""):
    """A small CNN on m nodes from one CPU draw placed on cuda:0, one IDPA
    batch, B 16, over the pool ``devices``."""
    from repro_torch.core.bpt_trainer import BPTTrainer
    from repro_torch.core.engine import engine_config
    from repro_torch.core.tree import tree_map
    from repro_torch.core.types import TrainConfig
    from repro_torch.data.pipeline import IDPADataset
    from repro_torch.data.synthetic import image_dataset
    from repro_torch.models import cnn
    cfg = cnn.CNNConfig(name="multi", image_size=8, conv_layers=1,
                        filters=4, fc_layers=2, fc_neurons=32)
    params = tree_map(lambda x: x.to("cuda:0"), cnn.init_cnn(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    xs, ys = image_dataset(64 * m, size=8, seed=0)
    ds = IDPADataset({"images": xs, "labels": ys}, num_nodes=m, batches=1)
    tc = TrainConfig(**engine_config(
        name, outer_nodes=m, optimizer="adamw", learning_rate=2e-3,
        warmup_steps=5, total_steps=100, local_steps=2, seed=0,
        mesh_name=mesh))
    tr = BPTTrainer(lambda p, b: (cnn.cnn_loss(p, b, cfg), {}), params, ds,
                    tc, batch_size=16, model_cfg=cfg if family else None,
                    plan_family=family, devices=devices)
    if name.startswith("heap"):
        orig = tr._local_round

        def pinned(p, o, node, step):
            p, o, loss, _ = orig(p, o, node, step)
            return p, o, loss, 1.0 + 0.25 * node

        tr._local_round = pinned
    return tr


@pytest.mark.cuda
def test_kernels_and_the_device_engines_on_distinct_cards(monkeypatch):
    """A pool of distinct cards (four H100s on one host): K1 on the second
    card while the first is current gives the plain version's output; the
    ``device`` engine on ``nodes2`` over two cards, on ``nodes2xmodel2``
    over four (batch and channel families: shards, collectives and the
    recombination cross cards) and ``heap-device`` are held to ``vmap`` /
    ``heap`` on cuda:0 within the outer layer's rtol 1e-5 / atol 1e-6;
    the batch family runs armed with the sync sanitizer (a copy between
    two cards makes the host wait for neither)."""
    _card()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards or more")
    import numpy as np
    from repro_torch import sanitize
    from repro_torch.core.tree import tree_leaves
    gen = torch.Generator("cuda:1").manual_seed(0)
    x = torch.randn((64, 200), generator=gen, device="cuda:1")
    w = torch.randn((200, 70), generator=gen, device="cuda:1")
    assert torch.cuda.current_device() == 0
    got = dense.dense_cuda(x, w, None)
    want = ref.dense_ref(x, w, None)
    torch.cuda.synchronize(1)
    assert got.device == x.device
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()

    def held(got, want):
        np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5,
                                   atol=1e-6)
        for a, b in zip(tree_leaves(got.final_params),
                        tree_leaves(want.final_params), strict=True):
            assert a.device == b.device == torch.device("cuda", 0)
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       rtol=1e-5, atol=1e-6)

    cards = [torch.device("cuda", i) for i in range(n)]
    vmap = _multi_trainer("vmap", 2).train(2)
    rep = _multi_trainer("device", 2, cards[:2], "nodes2").train(2)
    assert rep.backend == "device"
    held(rep, vmap)
    heap = _multi_trainer("heap", 2).train(2)
    rep = _multi_trainer("heap-device", 2, cards[:2]).train(2)
    assert rep.backend == "heap-device"
    held(rep, heap)
    if n < 4:
        return
    for family in ("batch", "channel"):
        if family == "batch":
            monkeypatch.setenv("REPRO_SANITIZE", "1")
        tr = _multi_trainer("device", 2, cards[:4], "nodes2xmodel2",
                            family)
        rep = tr.train(2)
        monkeypatch.delenv("REPRO_SANITIZE", raising=False)
        assert rep.backend == "device"
        assert tr.last_plan.mesh.model_devices(1, 2) == tuple(cards[2:4])
        held(rep, vmap)
    sanitize.clear_sync_log()
