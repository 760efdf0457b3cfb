"""The split-K products: how the reduction is cut for the f32 product
behind K1's f32 instance and K2 (``dense.dense_splits``), for K1's bf16
decode stream and prefill tile GEMM (``dense.bf16_splits``) and for K6's
tiles of output pixels (``conv2d.dw_tile``), and that the kernel
libraries rebuild when the header they share changes.  CPU only, no
``nvcc``: the kernels themselves are held against their plain versions on
a card in ``test_torch_kernels_cuda.py``.
"""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import build, conv2d, dense, ref  # noqa: E402

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
    (17, 4096, 512, (32, 128)),    # prefill: slices of the shallowest 128
    (24, 4096, 4096, (9, 480)),    # 32 tiles x 9 = 288 blocks
])
def test_bf16_splits_depend_on_shapes_only(M, K, N, want):
    assert dense.bf16_splits(M, N, K) == want


@pytest.mark.parametrize("M,rows", [(1, 0), (16, 0), (17, 64), (64, 64),
                                    (65, 128), (2048, 128)])
def test_bf16_rows_picks_the_route_by_m(M, rows):
    """The split-K stream up to M = 16, then the tile GEMM's 64-row tiles
    up to M = 64 and 128-row tiles above."""
    assert dense.bf16_rows(M) == rows


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


# ----------------------------------------------------------------------
# K1's bf16 prefill instance (M > 16): a tile GEMM split over K where its
# tiles alone leave the card idle
# ----------------------------------------------------------------------
TILE_STEP, TILE_MIN_STEPS = 32, 4
PREFILL_ROWS = [17, 24, 33, 63, 64, 65, 128, 129, 512, 5000]


def _prefill_blocks(M, N, K):
    """(tiles, the blocks the tile size wants) of the prefill GEMM."""
    rows = 64 if M <= 64 else 128
    return -(-M // rows) * -(-N // 128), 264 if rows == 64 else 132


@pytest.mark.parametrize("M", PREFILL_ROWS)
@pytest.mark.parametrize("K,N", LM_SHAPES + BF16_RAGGED)
def test_prefill_slices_cover_k_and_fill_the_card(M, K, N):
    splits, depth = dense.bf16_splits(M, N, K)
    assert (splits, depth) == dense.bf16_splits(M, N, K)   # shapes only
    assert depth % TILE_STEP == 0 and splits >= 1
    slices = [(z * depth, min(K, (z + 1) * depth)) for z in range(splits)]
    assert slices[0][0] == 0 and slices[-1][1] == K
    assert all(b == c for (_, b), (c, _) in zip(slices, slices[1:]))
    assert all(b > a for a, b in slices)                  # none empty
    # no slice shallower than 4 K steps where K splits at all
    assert splits == 1 or depth >= TILE_MIN_STEPS * TILE_STEP
    tiles, want = _prefill_blocks(M, N, K)
    steps = -(-K // TILE_STEP)
    if tiles >= want:                  # the tiles alone fill the card
        assert splits == 1
    elif steps // TILE_MIN_STEPS >= -(-want // tiles):
        assert tiles * splits >= want  # K allows filling it: filled
    else:                              # slices about as shallow as allowed
        assert depth < 2 * TILE_MIN_STEPS * TILE_STEP


@pytest.mark.parametrize("M", [17, 24, 64, 65, 512, 5000])
@pytest.mark.parametrize("K,N", LM_SHAPES)
def test_prefill_blocks_fill_the_card_at_the_lm_shapes(M, K, N):
    """Every Yi-6B, Phi-3 and Gemma-2 projection at prefill rows launches
    at least one block an SM, two where the tiles are 64-row."""
    splits, _ = dense.bf16_splits(M, N, K)
    tiles, want = _prefill_blocks(M, N, K)
    assert tiles * splits >= min(want, 128)


@pytest.mark.parametrize("M,K,N,want", [
    (24, 11008, 4096, (9, 1248)),   # Yi-6B's down projection: 288 blocks
    (24, 4096, 11008, (4, 1024)),   # 86 tiles x 4
    (64, 36864, 4608, (8, 4608)),   # Gemma-2's down projection
    (64, 4608, 36864, (1, 4608)),   # 288 tiles: no split
    (65, 4096, 4096, (5, 832)),     # 128-row tiles from M = 65 on
    (512, 4608, 4096, (2, 2304)),   # 128 tiles: two slices
    (512, 36864, 4608, (1, 36864)),
    (5000, 4608, 36864, (1, 4608)), (5000, 36864, 4608, (1, 36864)),
    (17, 72, 70, (1, 96)),          # K too short to split
])
def test_prefill_splits_depend_on_shapes_only(M, K, N, want):
    assert dense.bf16_splits(M, N, K) == want


@pytest.mark.parametrize("M,K,N", [(24, 4099, 130), (65, 1000, 77),
                                   (33, 11008, 64)])
def test_prefill_slice_partials_in_order_give_the_product(M, K, N):
    """What the prefill instance's two passes compute, through the plain
    version: each slice's product of the bf16 operands in f32, added in
    slice order, then bias and relu, equals the whole product."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).bfloat16().float()
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)
                         ).bfloat16().float()
    b = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    splits, depth = dense.bf16_splits(M, N, K)
    assert splits > 1
    total = torch.zeros((M, N))
    for z in range(splits):
        lo, hi = z * depth, min(K, (z + 1) * depth)
        total += ref.dense_ref(x[:, lo:hi], w[lo:hi])
    got = torch.relu(total + b)
    want = ref.dense_ref(x.double(), w.double(), b.double(), "relu")
    assert (got.double() - want).abs().max().item() <= \
        1e-5 * want.abs().max().item()


# ----------------------------------------------------------------------
# K6: one tile of output pixels a pass-1 block, partials added in order
# ----------------------------------------------------------------------
CASE7_CONV = [(64, 32, 32, 3, 12, 3, "SAME"), (64, 16, 16, 12, 12, 3, "SAME"),
              (64, 8, 8, 12, 12, 3, "SAME"), (64, 4, 4, 12, 12, 3, "SAME")]
RAGGED_CONV = [(3, 9, 7, 3, 5, 2, "SAME"), (3, 9, 7, 3, 5, 4, "SAME"),
               (3, 9, 7, 3, 5, 7, "SAME"), (3, 9, 7, 4, 20, 3, "VALID"),
               (1, 8, 8, 12, 12, 7, "VALID"), (5, 6, 6, 12, 12, 7, "SAME")]
WIDE_CONV = [(8, 224, 224, 64, 64, 3, "SAME"), (2, 56, 56, 512, 512, 3, "SAME"),
             (1, 5, 300, 3, 16, 5, "SAME"), (7, 3, 3, 33, 17, 1, "VALID"),
             # past 48 KB of shared memory a block: 145 KB and 219 KB tiles
             (1, 8, 8, 2048, 16, 3, "SAME"), (1, 6, 6, 1000, 8, 7, "SAME")]
DW_SMEM_LIMIT = 227 * 1024   # the H100's opt-in shared memory a block


def _out_hw(H, W, k, pad):
    return (H, W) if pad == "SAME" else (H - k + 1, W - k + 1)


def _tiles(B, Ho, Wo, tile):
    """Every tile's (images, rows, columns) ranges in the launch's order
    (columns fastest, then rows, then images), clipped at the edges."""
    tb, th, tw = tile
    return [((b, min(B, b + tb)), (h, min(Ho, h + th)), (w, min(Wo, w + tw)))
            for b in range(0, B, tb) for h in range(0, Ho, th)
            for w in range(0, Wo, tw)]


@pytest.mark.parametrize("B,H,W,Cin,Cout,k,pad",
                         CASE7_CONV + RAGGED_CONV + WIDE_CONV)
def test_dw_tiles_cover_every_pixel_once_and_fit(B, H, W, Cin, Cout, k, pad):
    Ho, Wo = _out_hw(H, W, k, pad)
    tile = conv2d.dw_tile(B, Ho, Wo, Cin, Cout, k, k)
    assert tile == conv2d.dw_tile(B, Ho, Wo, Cin, Cout, k, k)  # shapes only
    assert conv2d.dw_smem(tile, Cin, Cout, k, k) <= DW_SMEM_LIMIT
    seen = np.zeros((B, Ho, Wo), np.int64)
    tiles = _tiles(B, Ho, Wo, tile)
    assert len(tiles) == conv2d.dw_splits(B, Ho, Wo, Cin, Cout, k, k)
    for (b0, b1), (h0, h1), (w0, w1) in tiles:
        assert b1 > b0 and h1 > h0 and w1 > w0          # none empty
        seen[b0:b1, h0:h1, w0:w1] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("B,H,W,Cin,Cout,k,want", [
    (64, 32, 32, 3, 12, 3, (1, 8, 32)),    # 256 pixels, 256 tiles
    (64, 16, 16, 12, 12, 3, (1, 4, 16)),   # 64 pixels: 256 tiles
    (64, 8, 8, 12, 12, 3, (1, 2, 8)),      # 16 pixels: 256 tiles
    (64, 4, 4, 12, 12, 3, (1, 4, 4)),      # whole images: 64 tiles
    (2, 2, 2, 3, 12, 3, (2, 2, 2)),        # two images a block
    (3, 9, 7, 3, 5, 2, (1, 2, 7)),
    (2, 56, 56, 512, 512, 3, (1, 1, 32)),  # wide channels: 208 KB
    (1, 6, 6, 1000, 8, 7, (1, 1, 2)),      # smem halves it from 16 pixels
])
def test_dw_tile_depends_on_shapes_only(B, H, W, Cin, Cout, k, want):
    assert conv2d.dw_tile(B, H, W, Cin, Cout, k, k) == want


def test_dw_tile_refuses_a_patch_past_the_block_limit():
    """One pixel's 3 x 3 x 6400 patch fits a block; 3 x 3 x 7000 does not,
    and the chooser says so rather than hand the kernel a tile it
    refuses."""
    assert conv2d.dw_tile(1, 8, 8, 6400, 16, 3, 3) == (1, 1, 1)
    with pytest.raises(ValueError, match="does not fit"):
        conv2d.dw_tile(1, 8, 8, 7000, 16, 3, 3)


def test_dw_tile_blocks_fill_the_card_where_the_layer_allows():
    """One tile an SM wherever B.H.W has 16 pixels for each of 132 SMs."""
    for B, H, W, Cin, Cout, k, _ in CASE7_CONV + WIDE_CONV:
        if B * H * W >= 132 * 16:
            assert conv2d.dw_splits(B, H, W, Cin, Cout, k, k) >= 132


@pytest.mark.parametrize("B,H,W,Cin,Cout,k,pad",
                         [(64, 8, 8, 12, 12, 3, "SAME"),
                          (64, 4, 4, 12, 12, 3, "SAME")] + RAGGED_CONV)
def test_dw_tile_partials_in_order_give_the_gradient(B, H, W, Cin, Cout, k,
                                                      pad):
    """What K6's two passes compute, through the plain version: each
    tile's (dw, db) from its pixels alone (g masked by ``out > 0`` and
    zero outside the tile), added in tile order, equals the whole."""
    rng = np.random.default_rng(3)
    Ho, Wo = _out_hw(H, W, k, pad)
    x = torch.from_numpy(rng.standard_normal((B, H, W, Cin)).astype(
        np.float32))
    g = torch.from_numpy(rng.standard_normal((B, Ho, Wo, Cout)).astype(
        np.float32))
    out = torch.relu(torch.from_numpy(rng.standard_normal(
        (B, Ho, Wo, Cout)).astype(np.float32)))
    ws = (k, k, Cin, Cout)
    dw, db = torch.zeros(ws), torch.zeros(Cout)
    for (b0, b1), (h0, h1), (w0, w1) in _tiles(
            B, Ho, Wo, conv2d.dw_tile(B, Ho, Wo, Cin, Cout, k, k)):
        gt = torch.zeros_like(g)
        gt[b0:b1, h0:h1, w0:w1] = g[b0:b1, h0:h1, w0:w1]
        pw, pb = ref.conv2d_dw_ref(x, gt, ws, pad, out)
        dw += pw
        db += pb
    want_w, want_b = ref.conv2d_dw_ref(x.double(), g.double(), ws, pad,
                                       out.double())
    scale = max(want_w.abs().max().item(), want_b.abs().max().item(), 1.0)
    assert (dw.double() - want_w).abs().max().item() <= 1e-4 * scale
    assert (db.double() - want_b).abs().max().item() <= 1e-4 * scale


# ----------------------------------------------------------------------
# K4/K5: one tile of output pixels a block, the reduction in chunks of
# channels (and taps) where one block's shared memory is too small
# ----------------------------------------------------------------------
CONV_WIDE = [(2, 9, 7, 4, 300, 3, "SAME"), (1, 30, 30, 8, 16, 25, "SAME"),
             (140, 3, 3, 4, 5, 3, "SAME")]


def _tile_plans(B, H, W, Cin, Cout, k, pad):
    """K4's and K5's (flip, in channels, out channels, output rows and
    columns, conv_tile's pick) for a forward conv of these shapes."""
    Ho, Wo = _out_hw(H, W, k, pad)
    return [(False, Cin, Cout, Ho, Wo,
             conv2d.conv_tile(B, Ho, Wo, Cin, Cout, k, k, False)),
            (True, Cout, Cin, H, W,
             conv2d.conv_tile(B, H, W, Cout, Cin, k, k, True))]


@pytest.mark.parametrize("B,H,W,Cin,Cout,k,pad",
                         CASE7_CONV + RAGGED_CONV + WIDE_CONV + CONV_WIDE)
def test_conv_tiles_cover_every_pixel_once_and_fit(B, H, W, Cin, Cout, k,
                                                   pad):
    for flip, ci, co, Ho, Wo, plan in _tile_plans(B, H, W, Cin, Cout, k, pad):
        tb, th, tw, chunk, taps = plan
        assert plan == conv2d.conv_tile(B, Ho, Wo, ci, co, k, k, flip)
        assert tb * th * tw <= 256 and 1 <= chunk <= ci and \
            1 <= taps <= k * k
        assert conv2d.conv_smem((tb, th, tw), chunk, taps, ci, co, k, k,
                                flip) <= DW_SMEM_LIMIT
        seen = np.zeros((B, Ho, Wo), np.int64)
        tiles = _tiles(B, Ho, Wo, (tb, th, tw))
        assert len(tiles) == conv2d.conv_tiles(B, Ho, Wo, ci, co, k, k,
                                               flip)
        for (b0, b1), (h0, h1), (w0, w1) in tiles:
            assert b1 > b0 and h1 > h0 and w1 > w0          # none empty
            seen[b0:b1, h0:h1, w0:w1] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("B,H,W,Cin,Cout,k,flip,want", [
    (64, 32, 32, 3, 12, 3, False, (1, 8, 32, 3, 9)),    # 256 pixels
    (64, 32, 32, 12, 3, 3, True, (1, 8, 32, 12, 9)),    # K5 of layer 0
    (64, 16, 16, 12, 12, 3, False, (1, 4, 16, 12, 9)),  # 64 pixels
    (64, 8, 8, 12, 12, 3, False, (1, 2, 8, 12, 9)),     # 16 pixels
    (64, 4, 4, 12, 12, 3, True, (1, 1, 4, 12, 9)),      # 4: 256 tiles
    (3, 9, 7, 3, 5, 2, False, (1, 1, 4, 3, 4)),
    (140, 3, 3, 4, 5, 3, False, (1, 2, 3, 4, 9)),       # 6 pixels
    (1, 8, 8, 2048, 16, 3, False, (1, 1, 4, 176, 9)),   # 12 chunks of Cin
    (1, 8, 8, 16, 2048, 3, True, (1, 1, 4, 16, 9)),     # 128 column tiles
    (2, 56, 56, 512, 512, 3, False, (1, 1, 32, 116, 9)),
    (1, 30, 30, 8, 16, 25, False, (1, 1, 1, 1, 409)),   # chunks of taps
])
def test_conv_tile_depends_on_shapes_only(B, H, W, Cin, Cout, k, flip, want):
    assert conv2d.conv_tile(B, H, W, Cin, Cout, k, k, flip) == want


def test_conv_tile_refuses_a_patch_past_the_block_limit():
    """One pixel's single-channel 79 x 79 patch fits K4's ring and 57 x 57
    fits K5's (which holds the mask beside it); 81 x 81 and 59 x 59 do not,
    and the chooser says so rather than hand the kernel a block it
    refuses."""
    assert conv2d.conv_tile(1, 100, 100, 8, 16, 79, 79, False)[3] == 1
    assert conv2d.conv_tile(1, 100, 100, 8, 16, 57, 57, True)[3] == 1
    for k, flip in ((81, False), (59, True)):
        with pytest.raises(ValueError, match="does not fit"):
            conv2d.conv_tile(1, 100, 100, 8, 16, k, k, flip)


def test_conv_tile_blocks_fill_the_card_where_the_layer_allows():
    """One tile an SM wherever B.Ho.Wo has 4 pixels for each of 132 SMs."""
    for B, H, W, Cin, Cout, k, pad in CASE7_CONV + WIDE_CONV + CONV_WIDE:
        for flip, ci, co, Ho, Wo, _ in _tile_plans(B, H, W, Cin, Cout, k,
                                                   pad):
            if B * Ho * Wo >= 132 * 4:
                assert conv2d.conv_tiles(B, Ho, Wo, ci, co, k, k,
                                         flip) >= 132


@pytest.mark.parametrize("B,H,W,Cin,Cout,k,pad",
                         [(1, 8, 8, 2048, 16, 3, "SAME"),
                          (1, 30, 30, 8, 16, 25, "SAME"),
                          (3, 9, 7, 4, 20, 3, "VALID")])
def test_conv_chunks_in_order_give_the_conv(B, H, W, Cin, Cout, k, pad):
    """What K4's ring computes, through the plain version: the conv of each
    chunk's channels and taps alone, added in the kernel's chunk order
    (channel chunks outer, tap chunks inner), then bias and relu, equals
    the whole."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((B, H, W, Cin)).astype(
        np.float32))
    w = torch.from_numpy((rng.standard_normal((k, k, Cin, Cout))
                          / np.sqrt(k * k * Cin)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(Cout).astype(np.float32))
    Ho, Wo = _out_hw(H, W, k, pad)
    _, _, _, chunk, taps = conv2d.conv_tile(B, Ho, Wo, Cin, Cout, k, k,
                                            False)
    total = torch.zeros((B, Ho, Wo, Cout))
    for c0 in range(0, Cin, chunk):
        for t0 in range(0, k * k, taps):
            keep = torch.zeros((k * k, 1, 1))
            keep[t0:t0 + taps] = 1.0
            wc = (w * keep.reshape(k, k, 1, 1))[:, :, c0:c0 + chunk]
            total += ref.conv2d_ref(x[..., c0:c0 + chunk], wc, pad)
    got = torch.relu(total + b)
    want = ref.conv2d_fused_ref(x.double(), w.double(), b.double(), pad,
                                activation="relu")
    assert (got.double() - want).abs().max().item() <= \
        1e-5 * want.abs().max().item()


# ----------------------------------------------------------------------
# K3: [x, 1]^T (g masked) on the split-K product
# ----------------------------------------------------------------------
@pytest.mark.parametrize("M,Din,Dout,want", [
    (64, 192, 2000, 1), (64, 2000, 2000, 1), (64, 2000, 10, 1),  # case7
    (4096, 77, 10, 32),   # two tiles: 32 slices of 128 rows
    (1000, 64, 64, 7),    # the row of ones adds a tile row: 2 tiles
    (37, 77, 1000, 1), (128, 10, 10, 1), (256, 10, 10, 2)])
def test_dwdb_splits_fill_the_card_and_depend_on_shapes_only(M, Din, Dout,
                                                             want):
    assert dense.dwdb_splits(M, Din, Dout) == want
    splits = dense.dwdb_splits(M, Din, Dout)
    slices = _slices(M, splits)
    assert slices[0][0] == 0 and slices[-1][1] == M
    assert all(b > a for a, b in slices)


@pytest.mark.parametrize("M,Din,Dout", [(64, 192, 70), (4096, 77, 10),
                                        (1000, 64, 64), (5, 3, 130)])
def test_dwdb_slices_with_a_row_of_ones_give_dw_and_db(M, Din, Dout):
    """What K3's two passes compute, in plain f32: [x, 1]^T (g masked) over
    each slice of the rows, added in slice order, is dw in its first Din
    rows and db in its last."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((M, Din)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((M, Dout)).astype(np.float32))
    out = torch.relu(torch.from_numpy(rng.standard_normal(
        (M, Dout)).astype(np.float32)))
    gm = g * (out > 0)
    xa = torch.cat([x, torch.ones((M, 1))], dim=1)
    total = torch.zeros((Din + 1, Dout))
    for lo, hi in _slices(M, dense.dwdb_splits(M, Din, Dout)):
        total += xa[lo:hi].t() @ gm[lo:hi]
    want_w, want_b = ref.dense_dwdb_ref(x.double(), g.double(),
                                        out.double())
    scale = max(want_w.abs().max().item(), want_b.abs().max().item(), 1.0)
    assert (total[:Din].double() - want_w).abs().max().item() <= 1e-4 * scale
    assert (total[Din].double() - want_b).abs().max().item() <= 1e-4 * scale


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
    ("dense_fwd", "cp_async.cuh"), ("flash_attention", "cp_async.cuh"),
    ("conv2d", "cp_async.cuh"), ("dense_bwd", "wgmma_bf16.cuh")])
def test_sources_include_the_shared_header(name, header):
    text = (build._HERE / build.SOURCES[name]).read_text()
    assert f'#include "{header}"' in text
    assert (build.CSRC / header).is_file()
