"""The LM's training path in the port against the JAX package, on the
CPU: ``lm.loss_fn`` and every gradient leaf against
``jax.value_and_grad(repro.models.lm.loss_fn)`` on reduced Yi-6B, Phi-3,
Gemma-2 (soft-caps, post-norms, windows), Qwen3-MoE (``qk_norm``, the
moe block and its load-balance aux), Granite-MoE, Mamba2 (the ssm block)
and Hymba (the hybrid block), f32 and bf16, with a CE chunk that pads and
labels of -1; ``remat`` on and off.  Then the two
kernels' Functions this path adds a bf16 or backward instance to:
``DenseFunction`` in bf16 against ``jax.vjp`` of the reference's Pallas
``dense_pallas`` (interpret mode), and ``rmsnorm_bwd_ref`` (the CPU path
of ``RmsNormFunction``) against ``jax.grad`` of the reference's norm.

Tolerances: f32 at ``tests/test_models.py``'s atol 2e-5 / rtol 1e-4
(seen: under 3% of it); bf16 loss within 5e-3 and gradients within atol
3e-2 / rtol 3e-2, tighter than ``tests/test_models.py``'s bf16 atol 0.15
/ rtol 0.1 (seen: 0.008 at most).  bf16 kernel outputs: one bf16
rounding (1e-2 x max|ref|), f32 gradients 1e-4 x max(max|ref|, 1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.core.bpt_trainer import BPTTrainer as JTrainer  # noqa: E402
from repro.core.types import TrainConfig as JTrainConfig  # noqa: E402
from repro.data import synthetic  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import bpt_trainer  # noqa: E402
from repro_torch.core.types import TrainConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

ARCHS = ("yi-6b", "phi3-mini-3.8b", "gemma2-27b", "qwen3-moe-30b-a3b",
         "granite-moe-3b-a800m", "mamba2-370m", "hymba-1.5b")
TOL = {"float32": dict(loss=2e-5, atol=2e-5, rtol=1e-4),
       "bfloat16": dict(loss=5e-3, atol=3e-2, rtol=3e-2)}
MOE = ("qwen3-moe-30b-a3b", "granite-moe-3b-a800m")
B, S, CHUNK = 2, 12, 5             # 3 CE chunks, the last padded by 3


def _batch(vocab):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[0, 3] = -1                  # ignored positions, inside a chunk
    labels[1, -2:] = -1                # ... and in the padded one
    return toks, labels


@pytest.fixture(scope="module")
def jax_runs():
    """arch, dtype -> (numpy params, tokens, labels, JAX loss, grads,
    JAX aux)."""
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            jcfg = dataclasses.replace(jconfigs.get_reduced(arch),
                                       dtype=dtype, ce_chunk=CHUNK)
            jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
            toks, labels = _batch(jcfg.vocab_size)
            fn = jax.jit(jax.value_and_grad(
                lambda p, b: jlm.loss_fn(p, b, jcfg), has_aux=True))
            (loss, parts), grads = fn(jp, {"tokens": jnp.asarray(toks),
                                           "labels": jnp.asarray(labels)})
            cache[(arch, dtype)] = (
                jax.tree_util.tree_map(np.asarray, jp), toks, labels,
                float(loss), [np.asarray(g, np.float32)
                              for g in jax.tree_util.tree_leaves(grads)],
                float(parts["aux"]))
        return cache[(arch, dtype)]
    return get


def _port_loss_and_grads(tree, toks, labels, arch, dtype, remat):
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype=dtype,
                              ce_chunk=CHUNK)
    params = params_from_numpy(tree, cfg, device="cpu")
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, aux = lm.loss_fn(tree_unflatten(params, leaves),
                           {"tokens": torch.from_numpy(toks),
                            "labels": torch.from_numpy(labels)},
                           cfg, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), aux, grads


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_leaf_match_jax(jax_runs, arch, dtype, remat):
    tree, toks, labels, jloss, jgrads, jaux = jax_runs(arch, dtype)
    loss, aux, grads = _port_loss_and_grads(tree, toks, labels, arch, dtype,
                                            remat)
    tol = TOL[dtype]
    assert abs(float(loss) - jloss) <= tol["loss"] * max(1.0, abs(jloss))
    if arch in MOE:      # the moe layers' load-balance aux, the reference's
        assert jaux > 0
        assert abs(float(aux["aux"].detach()) - jaux) <= tol["loss"] * jaux
        assert torch.allclose(loss, aux["ce"] + 0.01 * aux["aux"],
                              rtol=1e-6, atol=0)
    else:
        assert float(aux["aux"]) == jaux == 0.0 and bool(aux["ce"] == loss)
    assert len(grads) == len(jgrads)
    for got, want in zip(grads, jgrads):
        assert got.dtype == torch.float32           # the f32 masters'
        np.testing.assert_allclose(got.numpy(), want, atol=tol["atol"],
                                   rtol=tol["rtol"])


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_loss_and_grads(jax_runs, arch):
    """Recomputing each block (and each CE chunk) in the backward gives
    the bits of the plain backward on the CPU."""
    tree, toks, labels = jax_runs(arch, "bfloat16")[:3]
    plain = _port_loss_and_grads(tree, toks, labels, arch, "bfloat16", False)
    remat = _port_loss_and_grads(tree, toks, labels, arch, "bfloat16", True)
    assert torch.equal(plain[0], remat[0])
    assert all(torch.equal(a, b) for a, b in zip(plain[2], remat[2]))


HELD_B, HELD_S = 8, 32


def _held_out_trajectory(arch, steps, **cfg_kw):
    """Reduced ``arch`` in f32 (``cfg_kw`` replaced in both packages'
    configs), trained as ``chip_smoke.py``'s phases 4h and 4k train it at
    full width (AdamW, lr 1e-3, warmup 2 then cosine over ``steps``,
    grad_clip 1.0, a new ``lm_corpus`` batch a step; here B 8 x S 32) by
    the reference trainer's own jitted step and by the port's
    ``make_node_round``, from the same numpy params.  Returns, after
    every step, (reference, port) readings of a held-out batch's
    objective, CE and aux, and prints them (``pytest -s``)."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), dtype="float32",
                               **cfg_kw)
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32",
                              **cfg_kw)
    corpus = synthetic.lm_corpus((steps + 1) * HELD_B * HELD_S + 1,
                                 jcfg.vocab_size, seed=0)
    n = (len(corpus) - 1) // HELD_S
    rows = np.stack([corpus[i * HELD_S:(i + 1) * HELD_S + 1]
                     for i in range(n)]).astype(np.int32)
    batches = [rows[i * HELD_B:(i + 1) * HELD_B] for i in range(steps + 1)]
    held = batches.pop()

    def jloss(p, r):
        return jlm.loss_fn(p, {"tokens": r[:, :-1], "labels": r[:, 1:]},
                           jcfg)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    kw = dict(optimizer="adamw", learning_rate=1e-3, warmup_steps=2,
              total_steps=steps, grad_clip=1.0)
    ref_trainer = JTrainer(jloss, jp, None, JTrainConfig(**kw), HELD_B)
    jheld = jax.jit(lambda p: jloss(p, jnp.asarray(held)))
    jstate = ref_trainer.opt.init(jp)

    def loss_fn(p, b):
        r = b["rows"]
        return lm.loss_fn(p, {"tokens": r[:, :-1], "labels": r[:, 1:]}, cfg)
    params = params_from_numpy(tree, cfg, device="cpu")
    state = make_optimizer("adamw").init(params)
    node_round = bpt_trainer.make_node_round(
        loss_fn, TrainConfig(**kw, local_steps=1))

    def port_held(p):
        with torch.no_grad():
            loss, parts = loss_fn(p, {"rows": torch.from_numpy(held)})
        return float(loss), float(parts["ce"]), float(parts["aux"])

    def ref_held(p):
        loss, parts = jheld(p)
        return float(loss), float(parts["ce"]), float(parts["aux"])
    trace = [(ref_held(jp), port_held(params))]
    for i, r in enumerate(batches):
        jp, jstate, _ = ref_trainer._train_step(jp, jstate, jnp.asarray(r),
                                                i)
        params, state, _ = node_round(params, state,
                                      {"rows": torch.from_numpy(r[None])}, i)
        trace.append((ref_held(jp), port_held(params)))
    for i, (want, got) in enumerate(trace):
        print(f"{arch} step {i:>2} held-out objective / ce / aux: reference "
              + " / ".join(f"{v:.6f}" for v in want) + "; port "
              + " / ".join(f"{v:.6f}" for v in got))
    return trace


@pytest.mark.parametrize("steps", [10, 40])
def test_moe_held_out_trajectory_matches_the_reference(steps):
    """Reduced Granite-MoE (``_held_out_trajectory``): the held-out
    objective, CE and aux after every step agree within rtol 1e-4 / atol
    1e-6 (the training CLI test's loss tolerance); the print shows how
    the load-balance aux moves while the CE falls."""
    trace = _held_out_trajectory("granite-moe-3b-a800m", steps)
    for i, (want, got) in enumerate(trace):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                   err_msg=f"after step {i}")


def test_chunked_cross_entropy_leaves_out_negative_labels():
    """Labels < 0 (and the padded tail of the last chunk) carry no loss:
    the mean runs over the valid positions only, at any chunk size."""
    cfg = configs.get_reduced("yi-6b")
    gen = torch.Generator().manual_seed(0)
    hidden = torch.randn((2, 7, 16), generator=gen)
    table = torch.randn((11, 16), generator=gen)
    labels = torch.randint(0, 11, (2, 7), generator=gen)
    labels[0, :3] = -1
    logits = (hidden @ table.T).float()
    nll = torch.nn.functional.cross_entropy(
        logits.reshape(-1, 11), labels.reshape(-1), ignore_index=-1)
    for chunk in (1, 3, 7, 0):
        got = lm.chunked_cross_entropy(hidden, table, labels, cfg, chunk)
        torch.testing.assert_close(got, nll, atol=1e-6, rtol=1e-6)


def test_frontend_embeds_are_not_ported():
    """Front-end embeddings reach only a config with a front end (the vlm
    path, ``tests/test_torch_vlm.py``): a config without one has no
    ``frontend_proj`` to project them, and the loss raises on its key, as
    the reference's does."""
    cfg = configs.get_reduced("yi-6b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(KeyError, match="frontend_proj"):
        lm.loss_fn(params, {"tokens": toks, "labels": toks,
                            "frontend_embeds": torch.zeros(1, 2, 256)}, cfg)


# ----------------------------------------------------------------------
# K2/K3 in bf16 and K9's backward: the CPU paths of their Functions
# ----------------------------------------------------------------------
def _one_rounding(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def _grad_gate(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("M,Din,Dout,bias,activation", [
    (24, 64, 40, False, "relu"), (5, 7, 9, True, "none"),
    (16, 32, 96, True, "none"), (33, 48, 20, False, "relu")])
def test_dense_function_bf16_matches_jax_pallas(M, Din, Dout, bias,
                                                activation):
    """``ops.dense`` on bf16 activations with an f32 weight (the LM's
    projections) and bias: dx in bf16, dw through the bf16 weight and
    back to f32, db in f32; against ``jax.vjp`` of the reference's
    ``ops.dense`` on its Pallas kernels in interpret mode.  No case puts
    a bias under the relu: the port's CPU forward is the reference's
    ``ref.dense_ref``, which adds a bf16 bias after rounding the product,
    where the Pallas kernel adds it in f32, so a pre-activation within a
    rounding of 0 can take the other side of the relu mask."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((M, Din)).astype(np.float32)
    w = (rng.standard_normal((Din, Dout)) / np.sqrt(Din)).astype(np.float32)
    b = rng.standard_normal((Dout,)).astype(np.float32) if bias \
        else np.zeros((Dout,), np.float32)
    g = rng.standard_normal((M, Dout)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    jout, vjp = jax.vjp(lambda x, w, b: jops.dense(
        x, w, b, activation=activation, impl="pallas"), jx, jnp.asarray(w),
        jnp.asarray(b))
    jdx, jdw, jdb = vjp(jnp.asarray(g, jnp.bfloat16))
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = ops.dense(tx, tw, tb, activation=activation)
    dx, dw, db = torch.autograd.grad(out, (tx, tw, tb),
                                     torch.from_numpy(g).bfloat16())
    assert (out.dtype, dx.dtype, dw.dtype, db.dtype) == (
        torch.bfloat16, torch.bfloat16, torch.float32, torch.float32)
    assert jdx.dtype == jnp.bfloat16 and jdw.dtype == jnp.float32
    _one_rounding(out.detach().float(), jout)
    _one_rounding(dx.float(), jdx)
    _one_rounding(dw, jdw)           # rounded to bf16 on the way, as jdw
    _grad_gate(db, jdb)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 5, 64), (7, 13), (1, 8)])
def test_rmsnorm_bwd_ref_matches_jax_grad(shape, dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (rng.standard_normal(shape[-1:]) * 0.1 + 1).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    jdt = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda x, s: jlayers.rms_norm({"scale": s}, x, 1e-6),
                     jnp.asarray(x, jdt), jnp.asarray(scale))
    jdx, jds = vjp(jnp.asarray(g, jdt))
    tdt = getattr(torch, dtype)
    dx, ds = ref.rmsnorm_bwd_ref(torch.from_numpy(x).to(tdt),
                                 torch.from_numpy(scale),
                                 torch.from_numpy(g).to(tdt), 1e-6)
    assert dx.dtype == tdt and ds.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=2e-5,
                                   rtol=1e-4)
    else:
        _one_rounding(dx.float(), jdx)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), atol=2e-5,
                               rtol=1e-4)


def test_ops_rmsnorm_gradient_goes_through_the_function():
    """On the CPU a norm that needs a gradient runs ``RmsNormFunction``
    (forward ``rmsnorm_ref``, backward ``rmsnorm_bwd_ref``): its
    gradients equal autograd's of the plain forward, the f32 scale's
    included, with no kernel launched."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((2, 3, 32), generator=gen).requires_grad_()
    s = (torch.randn((32,), generator=gen) * 0.1 + 1).requires_grad_()
    g = torch.randn((2, 3, 32), generator=gen)
    before = (rms.rmsnorm_cuda.launches, rms.rmsnorm_bwd_cuda.launches)
    out = ops.rmsnorm(x, s)
    assert out.grad_fn.next_functions[0][0].name() == \
        "RmsNormFunctionBackward"
    got = torch.autograd.grad(out, (x, s), g)
    want = torch.autograd.grad(ref.rmsnorm_ref(x, s), (x, s), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    assert (rms.rmsnorm_cuda.launches,
            rms.rmsnorm_bwd_cuda.launches) == before
