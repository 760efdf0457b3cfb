"""K2's and K3's bf16 routes, on the CPU: ``dense.bwd_bf16_plan`` (which
GEMM, tile, ring and grid each shape takes, and the persistent walk of
``dense_bwd_wgmma`` over the output tiles that its grid gives), K3's
dw in the caller's dtype through ``ref.dense_dwdb_ref``, and
``DenseFunction`` asking for db only where the bias needs a gradient,
against ``jax.vjp`` of the JAX package's ``dense_pallas`` in interpret
mode.  The kernels themselves run on a card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py`` phase 2d).

Tolerances: bf16 outputs one bf16 rounding (1e-2 x max|ref|), f32
gradients 1e-4 x max(max|ref|, 1), as ``test_torch_lm_train.py``.
"""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import dense, ops, ref  # noqa: E402

SMEM_LIMIT = 232_448           # an H100 block's opt-in shared memory
LM_ROWS = 1024                 # B 8 x S 128, a training step's rows
# every Phi-3-mini and Yi-6B projection: (Din, Dout)
LM_PROJECTIONS = sorted({(3072, 3072), (3072, 8192), (8192, 3072),
                         (4096, 4096), (4096, 512), (4096, 11008),
                         (11008, 4096)})
SHAPES = ([(LM_ROWS, din, dout) for din, dout in LM_PROJECTIONS]
          + [(1000, 3000, 3080), (24, 1000, 200), (1000, 8200, 1000),
             (24, 3000, 3000), (1, 8, 8), (5000, 4608, 36864),
             (129, 136, 264)])


def _walks(plan):
    """The output tiles each block computes, in its order, as (first row,
    first column): block b walks tiles b, b + grid, ..., tile t at rows (t
    % row tiles) x bm, columns (t // row tiles) x bn, as
    ``csrc/dense_bwd.cu``'s ``dense_bwd_wgmma`` does."""
    row_tiles = math.ceil(plan.rows / plan.bm)
    return [[(t % row_tiles * plan.bm, t // row_tiles * plan.bn)
             for t in range(b, plan.tiles, plan.grid)]
            for b in range(plan.grid)]


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_plan", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("din,dout", LM_PROJECTIONS)
def test_every_lm_projection_takes_the_wgmma_route(kernel, din, dout):
    plan = dense.bwd_bf16_plan(kernel, LM_ROWS, din, dout)
    assert plan.route == "wgmma" and plan.symbol.endswith("_wgmma")
    assert plan.bn in (128, 192, 256) and plan.bm == 128


@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("M,din,dout,masked,aligned", [
    (LM_ROWS, 3072, 3072, True, True),     # the relu mask
    (LM_ROWS, 3072, 8192, False, False),   # a pointer off 16 bytes
    (37, 100, 77, False, True),            # widths off 8: TMA's rule
    (5, 13, 9, True, True), (1000, 3072, 3076, False, True)])
def test_masked_or_unaligned_operands_take_the_tile_route(kernel, M, din,
                                                          dout, masked,
                                                          aligned):
    plan = dense.bwd_bf16_plan(kernel, M, din, dout, masked, aligned)
    assert plan.route == "tile"
    assert plan.symbol == {"K2": "dense_dx_bf16", "K3": "dense_dwdb_bf16"}[
        kernel]
    # the tile route's K3 output carries db as row Din
    assert (plan.rows, plan.cols) == ((M, din) if kernel == "K2"
                                      else (din + 1, dout))
    assert plan.tiles == plan.grid == (math.ceil(plan.rows / 128)
                                       * math.ceil(plan.cols / 128))


@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("M,din,dout", SHAPES)
def test_the_persistent_walk_covers_every_tile_once(kernel, M, din, dout):
    plan = dense.bwd_bf16_plan(kernel, M, din, dout)
    walks = _walks(plan)
    assert len(walks) == plan.grid == min(plan.tiles, 132)
    assert all(walks)                              # no block left idle
    seen = [t for walk in walks for t in walk]
    want = {(i * plan.bm, j * plan.bn)
            for i in range(math.ceil(plan.rows / plan.bm))
            for j in range(math.ceil(plan.cols / plan.bn))}
    assert len(seen) == len(set(seen)) == plan.tiles
    assert set(seen) == want
    # balanced: no block walks more than one tile beyond another
    assert max(map(len, walks)) - min(map(len, walks)) <= 1


@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("M,din,dout", SHAPES)
def test_shared_memory_fits_and_no_slice_is_empty(kernel, M, din, dout):
    for masked in (False, True):
        plan = dense.bwd_bf16_plan(kernel, M, din, dout, masked)
        assert 0 < plan.smem <= SMEM_LIMIT
        # no split: every tile walks the whole reduction, no slice empty
        assert 0 < plan.depth == (dout if kernel == "K2" else M)
        if plan.route == "wgmma":
            assert 2 <= plan.stages <= 6
            # one more stage would not fit (or the ring is at its deepest)
            stage = (plan.bm + plan.bn) * 64 * 2
            assert plan.stages == 6 or plan.smem + stage > SMEM_LIMIT


@pytest.mark.parametrize("kernel,M,din,dout,bn,tiles", [
    # K2's (1024, 3072): 128 x 192 tiles, 128 of them, one wave of 132
    ("K2", 1024, 3072, 3072, 192, 128), ("K2", 1024, 3072, 8192, 192, 128),
    # K2's (1024, 8192) for mlp_wo: 256 tiles of 128 x 256, two waves
    ("K2", 1024, 8192, 3072, 256, 256),
    ("K3", 1024, 3072, 3072, 192, 384), ("K3", 1024, 3072, 8192, 256, 768),
    ("K3", 1024, 8192, 3072, 256, 768)])
def test_the_tile_width_fills_the_card_at_phi3s_shapes(kernel, M, din, dout,
                                                       bn, tiles):
    plan = dense.bwd_bf16_plan(kernel, M, din, dout)
    assert (plan.bn, plan.tiles) == (bn, tiles)
    assert plan == dense.bwd_bf16_plan(kernel, M, din, dout)   # shapes only


def test_the_plan_takes_k2_or_k3_only():
    with pytest.raises(ValueError, match="K2"):
        dense.bwd_bf16_plan("K1", 8, 8, 8)


@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_phase_2d_hits_every_width_with_a_ragged_last_tile(kernel):
    """``chip_smoke.py``'s LM_BWD_EDGES, unmasked and aligned, take every
    tile width the plan can choose, each with a last column tile cut by
    the output's edge, at M = 1000 and 24."""
    edges = _chip_smoke().LM_BWD_EDGES
    assert {M for M, _, _ in edges} == {1000, 24}
    ragged = set()
    for M, din, dout in edges:
        plan = dense.bwd_bf16_plan(kernel, M, din, dout)
        assert plan.route == "wgmma"
        if plan.cols % plan.bn:
            ragged.add(plan.bn)
    assert ragged == {128, 192, 256}


# the prompt rows each serving phase of chip_smoke.py sends K1: the
# Poisson requests' prompt lengths, 4g's four 16-token prompts at once,
# and the long prompts
SERVED_ROWS = {"yi-6b": (8, 12, 16, 24),
               "gemma2-27b": (16, 32, 64, 5000),
               "qwen3-moe-30b-a3b": (8, 12, 16, 24, 64, 2048)}


@pytest.mark.parametrize("arch", sorted(SERVED_ROWS))
def test_phase_2_checks_the_plan_of_every_served_prefill(arch):
    """``chip_smoke.py``'s ``prefill_launches`` passes the row counts its
    serving phases send K1, each run at the block rows, splits and depth
    of a row count phase 2 holds against the plain version, and refuses a
    row count whose plan phase 2 does not check."""
    cs = _chip_smoke()
    assert cs.PREFILL_ROWS[arch] in SERVED_ROWS[arch]
    sums = {(arch, "prefill"): {"launches": 7}}
    served = {M: [7] for M in SERVED_ROWS[arch]}
    assert cs.prefill_launches(dense, sums, arch, served)["launches"] == 7
    with pytest.raises(AssertionError, match="did not hold"):
        cs.prefill_launches(dense, sums, arch, {**served, 300: [7]})


@pytest.mark.parametrize("M,din,dout", [(24, 64, 40), (5, 7, 9),
                                        (33, 48, 20)])
def test_dwdb_ref_writes_dw_in_the_callers_dtype(M, din, dout):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((M, din), np.float32))
    g = torch.from_numpy(rng.standard_normal((M, dout), np.float32))
    x, g = x.bfloat16(), g.bfloat16()
    dw32, db32 = ref.dense_dwdb_ref(x, g)
    dw16, db = ref.dense_dwdb_ref(x, g, dw_dtype=torch.bfloat16)
    assert dw32.dtype == torch.float32 and dw16.dtype == torch.bfloat16
    assert torch.equal(dw16, dw32.to(torch.bfloat16))
    assert torch.equal(db, db32)
    dw, none = ref.dense_dwdb_ref(x, g, dw_dtype=torch.bfloat16,
                                  want_db=False)
    assert none is None and torch.equal(dw, dw16)


def _record_dwdb(monkeypatch):
    calls = []
    real = ref.dense_dwdb_ref

    def spy(*a, **k):
        calls.append(k)
        return real(*a, **k)
    monkeypatch.setattr(ref, "dense_dwdb_ref", spy)
    return calls


@pytest.mark.parametrize("M,din,dout,activation", [
    (24, 64, 40, "relu"), (5, 7, 9, "none"), (16, 32, 96, "none")])
def test_dense_function_without_bias_asks_no_db(monkeypatch, M, din, dout,
                                                activation):
    """``ops.dense`` on bf16 activations with an f32 weight and no bias
    (every LM projection): K3's plain version is asked for dw in the bf16
    compute weight's dtype and for no db; dx and dw still match
    ``jax.vjp`` of the reference's ``dense_pallas`` in interpret mode."""
    calls = _record_dwdb(monkeypatch)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((M, din)).astype(np.float32)
    w = (rng.standard_normal((din, dout)) / np.sqrt(din)).astype(np.float32)
    g = rng.standard_normal((M, dout)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    _, vjp = jax.vjp(lambda x, w: jops.dense(
        x, w, None, activation=activation, impl="pallas"), jx,
        jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g, jnp.bfloat16))
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    dx, dw = torch.autograd.grad(ops.dense(tx, tw, activation=activation),
                                 (tx, tw), torch.from_numpy(g).bfloat16())
    assert calls == [{"dw_dtype": torch.bfloat16, "want_db": False}]
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    for got, want in ((dx, jdx), (dw, jdw)):   # one bf16 rounding each
        got = got.float().numpy()
        want = np.asarray(want, np.float32)
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_dense_function_with_a_bias_asks_for_db(monkeypatch):
    calls = _record_dwdb(monkeypatch)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((6, 16), np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 8), np.float32))
    b = torch.zeros(8, requires_grad=True)
    (db,) = torch.autograd.grad(ops.dense(x, w, b).sum(), (b,))
    assert calls == [{"dw_dtype": torch.float32, "want_db": True}]
    np.testing.assert_allclose(db.numpy(), np.full(8, 6.0), rtol=0,
                               atol=0)
