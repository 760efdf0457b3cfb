"""Fused dense layer: the wrappers around ``csrc/dense_fwd.cu`` (K1) and
``csrc/dense_bwd.cu`` (K2, K3), and its ``torch.autograd.Function``.

Counterpart of ``repro/kernels/dense.py``.  ``ops.dense`` calls
``dense_cuda`` directly where no gradient is needed (serving), and
``DenseFunction`` otherwise; inside it a CUDA tensor launches the kernels
and a CPU tensor takes their plain versions in ``ref.py``.

K1's f32 instance, K2 and K3 are one split-K product
(``csrc/gemm_f32.cuh``): ``dense_splits`` picks how many slices of the
reduction run on separate blocks (``dwdb_splits`` for K3), and the
launcher hands the kernel a scratch buffer for their partial sums.  K1's
bf16 instance splits its reduction the same way, as ``bf16_splits`` says:
the decode stream at M <= 16 always, the prefill tile GEMM where its tiles
alone would leave SMs idle.  K2's and K3's bf16 instances (the LM's
projections) take one of two unsplit routes, as ``bwd_bf16_plan`` says
from the shapes: a persistent TMA + ``wgmma`` GEMM for unmasked, aligned
operands (every LM projection), an ``mma.sync`` tile GEMM
(``dense_bwd_bf16_tile``) for the relu-masked or unaligned ones; no
scratch.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from . import launch, ref

__all__ = ["dense_cuda", "dense_dx_cuda", "dense_dwdb_cuda",
           "DenseFunction", "ACTIVATIONS", "dense_splits", "split_depth",
           "dwdb_splits", "bf16_splits", "BwdPlan", "bwd_bf16_plan"]

ACTIVATIONS = ("none", "relu")

_ENTRY = {torch.bfloat16: "dense_fwd_bf16", torch.float32: "dense_fwd_f32"}
_BWD_DTYPES = (torch.float32, torch.bfloat16)   # K2, K3

_SM_BLOCKS = 264   # two blocks on each of the H100's 132 SMs
_MIN_DEPTH = 128   # shallowest slice of K one split-K block reduces
_TILE, _DEPTH = 64, 16   # gemm_f32.cuh's output tile and K step
# dense_fwd.cu's bf16 split-K instance: rows it takes, output columns a
# block owns, K step (one ring stage), and the deepest slice whose x rows
# fit its shared memory, in K steps
_BF16_ROWS, _BF16_TILE_N, _BF16_STEP, _BF16_MAX_STEPS = 16, 64, 64, 16
# its prefill tile GEMM: rows a block owns up to M = 64 (the weight
# stream) and above, columns, K step, the shallowest slice in K steps, and
# the blocks each tile size wants before its slices stop splitting
_TILE_ROWS_STREAM, _TILE_ROWS, _TILE_N, _TILE_STEP = 64, 128, 128, 32
_TILE_MIN_STEPS = 4
_TILE_BLOCKS = {64: _SM_BLOCKS, 128: _SM_BLOCKS // 2}
# dense_bwd.cu's bf16 routes.  The TMA + wgmma GEMM: output rows a tile,
# the widths (wgmma's N) it may take, K a ring stage, the deepest ring,
# the block's shared-memory limit, its fixed part (1 KB of alignment
# slack, the ring's mbarriers) and the consumer warps' epilogue tiles.
# The mma.sync tile GEMM: 128 x 128 tiles, its shared memory by mask.
_WG_ROWS, _WG_WIDTHS, _WG_DEPTH, _WG_MAX_STAGES = 128, (256, 192, 128), 64, 6
_SMEM_LIMIT = 232_448
_WG_FIXED, _WG_STAGING = 1024 + 2 * _WG_MAX_STAGES * 8, 8 * 16 * 40 * 4
_WG_TILE_COST = 32   # a tile's fixed cost (ring fill, epilogue) in columns
_BWD_TILE = 128
_BWD_TILE_SMEM = {False: 81_920, True: 122_880}
_SMS = 132   # the H100's SMs: the plan's default


def split_depth(K: int, splits: int) -> int:
    """How deep each of ``splits`` slices of K is: ceil(K / splits)
    rounded up to the kernel's K step; the last slice takes what is left.
    The launchers hand it to ``gemm_f32.cuh``, which refuses a depth that
    leaves part of K out or a slice empty."""
    return math.ceil(math.ceil(K / splits) / _DEPTH) * _DEPTH


def dense_splits(M: int, N: int, K: int) -> int:
    """How many slices the f32 product C (M, N) = A (M, K) B (K, N) splits
    its reduction into: as many blocks as two on every SM hold, every
    slice at least ``_MIN_DEPTH`` deep, and none empty.  1 when K is short
    or the tiles alone fill the card.  It depends on the shapes only, so
    every run adds the same partials in the same order."""
    tiles = math.ceil(M / _TILE) * math.ceil(N / _TILE)
    splits = max(1, min(K // _MIN_DEPTH, _SM_BLOCKS // tiles))
    while splits > 1 and (splits - 1) * split_depth(K, splits) >= K:
        splits -= 1
    return splits


def dwdb_splits(M: int, Din: int, Dout: int) -> int:
    """How many slices K3 cuts its reduction over the M rows of x (M, Din)
    and g (M, Dout) into: ``dense_splits`` of its (Din + 1, Dout) output,
    dw and the row db.  1 at the CNN's 64 rows; a long M on a small output
    splits until the blocks fill the card."""
    return dense_splits(Din + 1, Dout, M)


@functools.lru_cache(maxsize=1024)   # every projection asks each call
def bf16_rows(M: int) -> int:
    """Rows one block of K1's bf16 instance owns at M rows: 0 on the
    split-K stream (M <= 16), else the tile GEMM's 64 (M <= 64) or 128."""
    if M <= _BF16_ROWS:
        return 0
    return _TILE_ROWS_STREAM if M <= _TILE_ROWS_STREAM else _TILE_ROWS


def bf16_splits(M: int, N: int, K: int) -> tuple[int, int]:
    """(splits, depth) of K1's bf16 instance for x (M, K) @ w (K, N).

    At M <= 16 (decode) the weight panel of each 64-column tile streams
    through ``splits`` blocks, each reducing one ``depth``-deep slice of K
    (a multiple of the 64-deep K step, at most 1024, the last slice taking
    what is left).  The depth is the largest that still gives every SM two
    blocks (tiles x splits >= 264), or one K step where K is too short for
    that.

    Above (prefill) the tile GEMM owns 64-row tiles up to M = 64 and
    128-row tiles beyond, 128 columns each.  Its slices are multiples of
    the 32-deep K step, of about equal depth, and as many as bring tiles x
    splits to 264 blocks (64-row tiles) or 132 (128-row tiles, 8 warps
    each), but none shallower than 128 (four steps); 1 where the tiles
    alone reach it.

    Every slice is non-empty.  Depends on the shapes only, so every run
    adds the same partials in the same order."""
    rows = bf16_rows(M)
    if rows:
        tiles = math.ceil(M / rows) * math.ceil(N / _TILE_N)
        steps = math.ceil(K / _TILE_STEP)
        low = min(steps, _TILE_MIN_STEPS)
        want = min(math.ceil(_TILE_BLOCKS[rows] / tiles), steps // low)
        depth = math.ceil(steps / want)
        while math.ceil(steps / depth) < want:   # rounding lost a slice
            depth -= 1
        return math.ceil(steps / depth), depth * _TILE_STEP
    steps = math.ceil(K / _BF16_STEP)
    want = math.ceil(_SM_BLOCKS / math.ceil(N / _BF16_TILE_N))
    depth = next((d for d in range(min(steps, _BF16_MAX_STEPS), 0, -1)
                  if math.ceil(steps / d) >= want), 1)
    return math.ceil(steps / depth), depth * _BF16_STEP


class BwdPlan(NamedTuple):
    """How K2 or K3 in bf16 runs at one shape (``bwd_bf16_plan``)."""
    route: str      # "wgmma" (TMA + wgmma, persistent) or "tile" (mma.sync)
    symbol: str     # the C entry in dense_bwd.cu
    rows: int       # the output C (rows, cols): K2 dx (M, Din), K3 dw
    cols: int       #   (Din, Dout), or (Din + 1, Dout) on the tile route
    depth: int      # the reduction every tile walks whole: K2 Dout, K3 M
    bm: int         # output rows a tile
    bn: int         # output columns a tile
    stages: int     # ring depth
    tiles: int      # output tiles
    grid: int       # blocks: one an SM (wgmma, at most `sms`) or a tile
    smem: int       # dynamic shared memory a block, bytes


def _wg_smem(bn: int, stages: int) -> int:
    return _WG_FIXED + stages * (_WG_ROWS + bn) * _WG_DEPTH * 2 + _WG_STAGING


@functools.lru_cache(maxsize=1024)
def bwd_bf16_plan(kernel: str, M: int, Din: int, Dout: int,
                  masked: bool = False, aligned: bool = True,
                  sms: int = _SMS) -> BwdPlan:
    """The route, tile and grid of K2 (``kernel="K2"``: dx (M, Din) = g
    w^T over Dout) or K3 (``"K3"``: dw (Din, Dout) = x^T g over M) in
    bf16.  ``masked``: a relu mask is applied to g; ``aligned``: every
    pointer is 16-byte aligned.

    Unmasked, aligned operands whose widths Din and Dout are multiples of
    8 (TMA's row-stride rule; every LM projection) take the TMA + wgmma
    GEMM: 128-row tiles N wide, N among 128, 192 and 256 the one that
    gives the busiest SM the least work, ceil(tiles / sms) x (N + 32),
    the 32 a tile's fixed cost (ring fill, epilogue) in columns (the
    wider N on a tie), as deep a ring as shared memory holds
    (at most 6 stages), and a persistent grid of min(tiles, sms) blocks.
    Everything else takes the 128 x 128 mma.sync tile GEMM, a block a tile
    (K3's output there carries db as row Din).  Neither splits its
    reduction.  Depends on the shapes (and the SM count) only.

    On the wgmma route block b walks tiles b, b + grid, ..., tile t at
    rows (t % row tiles) x bm and columns (t // row tiles) x bn
    (``dense_bwd_wgmma``)."""
    if kernel not in ("K2", "K3"):
        raise ValueError(f"kernel must be 'K2' or 'K3', got {kernel!r}")
    rows, cols, depth = (M, Din, Dout) if kernel == "K2" else (Din, Dout, M)
    if masked or not aligned or Din % 8 or Dout % 8:
        rows += kernel == "K3"   # the tile route's ones row: db
        tiles = math.ceil(rows / _BWD_TILE) * math.ceil(cols / _BWD_TILE)
        symbol = "dense_dx_bf16" if kernel == "K2" else "dense_dwdb_bf16"
        return BwdPlan("tile", symbol, rows, cols, depth, _BWD_TILE,
                       _BWD_TILE, 4, tiles, tiles, _BWD_TILE_SMEM[masked])
    row_tiles = math.ceil(rows / _WG_ROWS)
    bn = min(_WG_WIDTHS, key=lambda n: (
        math.ceil(row_tiles * math.ceil(cols / n) / sms)
        * (n + _WG_TILE_COST), -n))
    tiles = row_tiles * math.ceil(cols / bn)
    stages = min(_WG_MAX_STAGES, (_SMEM_LIMIT - _wg_smem(bn, 0))
                 // ((_WG_ROWS + bn) * _WG_DEPTH * 2))
    symbol = "dense_dx_bf16_wgmma" if kernel == "K2" \
        else "dense_dwdb_bf16_wgmma"
    return BwdPlan("wgmma", symbol, rows, cols, depth, _WG_ROWS, bn, stages,
                   tiles, min(tiles, sms), _wg_smem(bn, stages))


@functools.lru_cache(maxsize=16)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _aligned(*tensors) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def _scratch(splits, M, N, device):
    """Room for the (splits, M, N) f32 partial sums of a split-K launch
    (the stream's workspace, ``launch.workspace``), or None where the
    reduction does not split."""
    return None if splits == 1 else launch.workspace(splits * M * N, device)


def _split(M, N, K, device):
    """(splits, depth, the scratch for the partial sums or None) of the
    f32 product C (M, N) = A (M, K) B (K, N)."""
    splits = dense_splits(M, N, K)
    return splits, split_depth(K, splits), _scratch(splits, M, N, device)


def dense_cuda(x, w, b=None, activation: str = "none"):
    """act(x @ w + b) on the card: x (M, K), w (K, N), b (N,) float32 or
    None; x and w bfloat16 or float32, the same dtype, contiguous.

    Allocates the output (where the reduction splits, the partial sums go
    to the stream's workspace), launches on the current stream, raises if
    the launch was refused.  ``dense_cuda.launches`` counts the launches;
    a split product's two passes are one.
    """
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {ACTIVATIONS}")
    if x.dtype not in _ENTRY or w.dtype != x.dtype:
        raise TypeError(f"dense_cuda takes bfloat16 or float32 x and w of "
                        f"one dtype, got {x.dtype} and {w.dtype}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"dense_cuda takes x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    M, K = x.shape
    N = w.shape[1]
    if min(M, N, K) < 1:
        raise ValueError(f"dense_cuda needs M, N, K >= 1, got {M}, {N}, {K}")
    tensors = [x, w] if b is None else [x, w, b]
    if b is not None and (b.dtype != torch.float32 or b.shape != (N,)):
        raise ValueError(f"bias must be float32 of shape ({N},), got "
                         f"{b.dtype} {tuple(b.shape)}")
    if any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "dense_cuda is the forward-only launcher, outside autograd: "
            "call it on tensors that do not require grad, or differentiate "
            "through kernels.ops.dense")
    for t in tensors:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError("dense_cuda takes tensors on one CUDA device, "
                             f"got {[str(u.device) for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError("dense_cuda takes contiguous tensors")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if x.dtype == torch.float32:
        splits, depth, part = _split(M, N, K, x.device)
    else:
        splits, depth = bf16_splits(M, N, K)
        part = _scratch(splits, M, N, x.device)
    launch.run("dense_fwd", _ENTRY[x.dtype], x.device, (x, w, b, part, out),
               (M, N, K, activation == "relu", splits, depth))
    dense_cuda.launches += 1
    return out


dense_cuda.launches = 0


def dense_dx_cuda(g, w, out=None):
    """K2 on the card: dx = (g masked by ``out > 0``) @ w^T; g and ``out``
    (M, Dout), w (Din, Dout), all float32 or all bfloat16; dx in their
    dtype.  f32: the reduction over Dout is split as ``dense_splits(M,
    Din, Dout)`` says, and the two passes count as one launch on
    ``dense_dx_cuda.launches``.  bf16: one GEMM with f32 accumulators, dx
    rounded once, on the route ``bwd_bf16_plan`` picks."""
    dev, dt = launch.check_cuda("dense_dx_cuda", _BWD_DTYPES, g=g, w=w,
                                out=out)
    if g.ndim != 2 or w.ndim != 2 or g.shape[1] != w.shape[1] or (
            out is not None and out.shape != g.shape):
        raise ValueError(f"dense_dx_cuda takes g (M, Dout), w (Din, Dout) "
                         f"and out like g, got {tuple(g.shape)}, "
                         f"{tuple(w.shape)}")
    (M, Dout), Din = g.shape, w.shape[0]
    dx = torch.empty((M, Din), dtype=dt, device=dev)
    if dt == torch.bfloat16:
        plan = bwd_bf16_plan("K2", M, Din, Dout, out is not None,
                             _aligned(g, w, out, dx), _sm_count(dev))
        if plan.route == "wgmma":
            launch.run("dense_bwd", plan.symbol, dev, (g, w, dx),
                       (M, Din, Dout, plan.bn, plan.stages, plan.grid))
        else:
            launch.run("dense_bwd", plan.symbol, dev, (g, w, out, dx),
                       (M, Din, Dout))
    else:
        splits, depth, part = _split(M, Din, Dout, dev)
        launch.run("dense_bwd", "dense_dx_f32", dev, (g, w, out, part, dx),
                   (M, Din, Dout, splits, depth))
    dense_dx_cuda.launches += 1
    return dx


def dense_dwdb_cuda(x, g, out=None, dw_dtype=torch.float32,
                    want_db: bool = True):
    """K3 on the card, one launch: dw = x^T g (Din, Dout) in ``dw_dtype``
    (float32 or bfloat16) and, where ``want_db``, db = the sum of g's
    rows (Dout,) in f32 (else None), g masked by ``out > 0``; x (M, Din),
    g and ``out`` (M, Dout), all float32 or all bfloat16.  f32: one (Din +
    1, Dout) product over the M rows, dw and db its first Din rows and its
    last, the M rows split as ``dwdb_splits`` says (two passes count as
    one launch on ``dense_dwdb_cuda.launches``).  bf16: on the route
    ``bwd_bf16_plan`` picks; the wgmma route writes dw in ``dw_dtype``
    from its f32 accumulators (bf16 rounded once, the bits of the f32
    dw's ``.to(torch.bfloat16)``) and sums db only if asked; the tile
    route computes both in f32 and casts dw."""
    dev, dt = launch.check_cuda("dense_dwdb_cuda", _BWD_DTYPES, x=x, g=g,
                                out=out)
    if x.ndim != 2 or g.ndim != 2 or x.shape[0] != g.shape[0] or (
            out is not None and out.shape != g.shape):
        raise ValueError(f"dense_dwdb_cuda takes x (M, Din), g (M, Dout) "
                         f"and out like g, got {tuple(x.shape)}, "
                         f"{tuple(g.shape)}")
    if dw_dtype not in _BWD_DTYPES:
        raise TypeError(f"dense_dwdb_cuda writes dw in float32 or bfloat16,"
                        f" got {dw_dtype}")
    (M, Din), Dout = x.shape, g.shape[1]
    plan = None if dt != torch.bfloat16 else bwd_bf16_plan(
        "K3", M, Din, Dout, out is not None, _aligned(x, g, out),
        _sm_count(dev))
    if plan is not None and plan.route == "wgmma":
        dw = torch.empty((Din, Dout), dtype=dw_dtype, device=dev)
        db = torch.empty((Dout,), dtype=torch.float32, device=dev) \
            if want_db else None
        launch.run("dense_bwd", plan.symbol, dev, (x, g, dw, db),
                   (M, Din, Dout, plan.bn, plan.stages, plan.grid,
                    dw_dtype == torch.bfloat16))
        dense_dwdb_cuda.launches += 1
        return dw, db
    dwdb = torch.empty((Din + 1, Dout), dtype=torch.float32, device=dev)
    if plan is not None:
        launch.run("dense_bwd", plan.symbol, dev, (x, g, out, dwdb),
                   (M, Din, Dout))
    else:
        splits = dwdb_splits(M, Din, Dout)
        part = _scratch(splits, Din + 1, Dout, dev)
        launch.run("dense_bwd", "dense_dwdb_f32", dev,
                   (x, g, out, part, dwdb),
                   (M, Din, Dout, splits, split_depth(M, splits)))
    dense_dwdb_cuda.launches += 1
    return dwdb[:Din].to(dw_dtype), dwdb[Din] if want_db else None


dense_dx_cuda.launches = 0
dense_dwdb_cuda.launches = 0


class DenseFunction(torch.autograd.Function):
    """act(x @ w + b) with K1 forward and K2/K3 backward on the card (the
    plain versions on the CPU).  x (M, Din) and w (Din, Dout) of one
    dtype, b (Dout,) or None.  The relu mask comes from the saved output
    (out > 0 iff the pre-activation was > 0), as in the reference's
    ``_dense_bwd``; dx comes back in x's dtype, dw in w's (K3 writes it
    so) and db (f32) cast to b's, as ``_dense_bwd`` casts them.  K3 sums
    db only where b needs a gradient."""

    @staticmethod
    def forward(ctx, x, w, b, activation):
        if x.device.type == "cpu":
            out = ref.dense_ref(x, w, b, activation=activation)
        else:
            out = dense_cuda(x.detach(), w.detach(), launch.detached(b),
                             activation=activation)
        relu = activation == "relu"
        ctx.save_for_backward(x, w, out if relu else None)
        ctx.b_dtype = None if b is None else b.dtype
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w, out = (launch.detached(t) for t in ctx.saved_tensors)
        g = g.contiguous()
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = dw = db = None
        cpu = x.device.type == "cpu"
        if need_x:
            dx = (ref.dense_dx_ref if cpu else dense_dx_cuda)(
                g, w, out).to(x.dtype)
        if need_w or need_b:
            dw, db = (ref.dense_dwdb_ref if cpu else dense_dwdb_cuda)(
                x, g, out, dw_dtype=w.dtype, want_db=need_b)
            dw = dw if need_w else None
            db = db.to(ctx.b_dtype) if need_b else None
        return dx, dw, db, None
