"""The vlm path of the port (``repro_torch.models.frontends`` and the
front end of ``repro_torch.models.lm``) against ``repro.models.lm`` on
reduced InternVL2 (8 patch tokens), on the CPU: the same numpy params and
seeded numpy patch embeddings (rounded to bf16 in both packages) through
both, then ``forward``'s hidden state, ``launch/steps``'s prefill (the
last hidden state and every cache leaf), 4 decode steps after the
image prompt's cache is inserted into a serving cache, ``loss_fn`` and
every gradient leaf with the patch positions labelled -1; last, the
training CLI ``launch/train.py`` feeding its seeded patch embeddings
to every loss, each local step's loss and gradients held against the
reference's at the same params and batch.

Tolerances: ``tests/test_torch_lm.py``'s (f32 logits and hidden 1e-4,
caches 1e-5; bf16 0.05 and 0.08) and ``tests/test_torch_lm_train.py``'s
(f32 loss 2e-5, gradients atol 2e-5 / rtol 1e-4; bf16 loss 5e-3,
gradients atol / rtol 3e-2).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import frontends as jfrontends  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import frontends, lm  # noqa: E402
from repro_torch.weights import params_from_numpy, params_to_numpy  # noqa: E402

ARCH = "internvl2-26b"
TOL = {"float32": {"logits": 1e-4, "cache": 1e-5, "loss": 2e-5,
                   "atol": 2e-5, "rtol": 1e-4},
       "bfloat16": {"logits": 0.05, "cache": 0.08, "loss": 5e-3,
                    "atol": 3e-2, "rtol": 3e-2}}
CACHE_DT = {"float32": (jnp.float32, torch.float32),
            "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, S = 2, 11                         # text tokens after the 8 patches


def _pair(dtype, **kw):
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), dtype=dtype, **kw)
    tcfg = dataclasses.replace(configs.get_reduced(ARCH), dtype=dtype, **kw)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, tcfg, jp, params_from_numpy(tree, tcfg, device="cpu")


def _inputs(cfg, seed=1, batch=B, text=S):
    """Seeded tokens, labels (two of them -1) and patch embeddings, the
    embeddings as (jax bf16, torch bf16) of the same f32 draw."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, text)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (batch, text)).astype(np.int32)
    labels[0, 3] = labels[-1, -1] = -1
    fe = (rng.standard_normal((batch, cfg.num_frontend_tokens, cfg.d_model))
          * 0.02).astype(np.float32)
    return toks, labels, (jnp.asarray(fe, jnp.bfloat16),
                          torch.from_numpy(fe).to(torch.bfloat16))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def test_frontend_embed_shape_and_random_embeds():
    cfg = configs.get_reduced(ARCH)
    assert frontends.frontend_embed_shape(cfg, 3) == \
        jfrontends.frontend_embed_shape(jconfigs.get_reduced(ARCH), 3) == \
        (3, 8, 256)
    assert frontends.frontend_embed_shape(configs.get_reduced("yi-6b"),
                                          3) is None
    assert frontends.random_frontend_embeds(
        torch.Generator().manual_seed(0), configs.get_reduced("yi-6b"), 3,
        device="cpu") is None
    draw = [frontends.random_frontend_embeds(
        torch.Generator().manual_seed(7), cfg, 64, device="cpu")
        for _ in range(2)]
    assert draw[0].dtype == torch.bfloat16 and draw[0].shape == (64, 8, 256)
    assert torch.equal(draw[0], draw[1])
    assert abs(float(draw[0].float().std()) - 0.02) < 1e-3
    with pytest.raises(TypeError):
        frontends.random_frontend_embeds(None, cfg, 2, device="cpu")


def test_random_embeds_without_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        frontends.random_frontend_embeds(torch.Generator().manual_seed(0),
                                         configs.get_reduced(ARCH), 2)


def test_init_params_has_the_reference_frontend_proj():
    cfg = configs.get_reduced(ARCH)
    p = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    w = p["frontend_proj"]["w"]
    assert w.shape == (cfg.d_model, cfg.d_model) and w.dtype == torch.float32
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    jp = jlm.init_params(jax.random.PRNGKey(0), jconfigs.get_reduced(ARCH))
    assert sorted(p) == sorted(jp)
    cp = lm.compute_params(p, cfg)
    assert cp["frontend_proj"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_hidden_matches_jax(dtype):
    jcfg, tcfg, jp, tp = _pair(dtype)
    toks, _, (jfe, tfe) = _inputs(tcfg)
    jh, _, _ = jax.jit(lambda p, t, f: jlm.forward(p, t, jcfg,
                                                   frontend_embeds=f))(
        jp, jnp.asarray(toks), jfe)
    with torch.inference_mode():
        th, _, aux = lm.forward(tp, torch.from_numpy(toks), tcfg,
                                frontend_embeds=tfe)
    assert th.shape == (B, 8 + S, tcfg.d_model) and float(aux) == 0.0
    np.testing.assert_allclose(_f32(th), _f32(jh), atol=TOL[dtype]["logits"])


def _cache_leaves(got, want):
    for k in sorted(got):
        if isinstance(got[k], dict):
            yield from _cache_leaves(got[k], want[k])
        else:
            yield k, got[k], want[k]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_step_and_decode_match_jax(dtype):
    """``make_prefill_step`` on an image prompt (8 patches + 11 tokens):
    the last hidden state and every cache leaf; the reference's cache
    inserted into slots 0 and 2 of a 3-slot serving cache (slot 1 free) in
    both packages, then 4 decode steps at each row's own position, every
    row's logits and the lengths against the reference's."""
    jcfg, tcfg, jp, tp = _pair(dtype)
    jdt, tdt = CACHE_DT[dtype]
    toks, _, (jfe, tfe) = _inputs(tcfg)
    jlast, jc = jax.jit(jsteps.make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(toks), "frontend_embeds": jfe})
    with torch.inference_mode():
        tlast, tc = steps.make_prefill_step(tcfg)(
            tp, {"tokens": torch.from_numpy(toks), "frontend_embeds": tfe})
    tol = TOL[dtype]
    assert tlast.shape == (B, tcfg.d_model)
    np.testing.assert_allclose(_f32(tlast), _f32(jlast), atol=tol["logits"])
    for leaf, got, want in _cache_leaves(tc, jc):
        # bf16 caches in both dtypes (the forward's default): in f32 a
        # value may round to the neighbouring bf16 (one ulp, 2^-7 of it)
        assert tuple(got.shape) == want.shape and got.dtype == torch.bfloat16
        bound = 0.08 if dtype == "bfloat16" else \
            2.0 ** -7 * np.abs(_f32(want)) + 1e-6
        assert (np.abs(_f32(got) - _f32(want)) <= bound).all(), leaf

    # both serving caches take the reference's slice, so the decode steps
    # start from the same bits
    P = 8 + S
    jsl = jlm.DecodeCache(layers=jc, lengths=jnp.full((B,), P, jnp.int32))
    tsl = lm.DecodeCache(
        layers=jax.tree_util.tree_map(
            lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
                torch.bfloat16), jc),
        lengths=torch.full((B,), P, dtype=torch.int32))
    jcache = jlm.init_cache(3, P + 8, jcfg, dtype=jdt)
    tcache = lm.init_cache(3, P + 8, tcfg, dtype=tdt, device="cpu")
    for slot, row in ((0, 0), (2, 1)):
        jcache = jlm.cache_insert(jcache, jsl, slot, row)
        tcache = lm.cache_insert(tcache, tsl, slot, row)
    jdecode = jax.jit(lambda p, c, t: jlm.decode_step(p, c, None, t, jcfg))
    rng = np.random.default_rng(3)
    with torch.inference_mode():
        for _ in range(4):
            t = rng.integers(0, tcfg.vocab_size, (3, 1)).astype(np.int32)
            jl, jcache = jdecode(jp, jcache, jnp.asarray(t))
            tl, tcache = lm.decode_step(tp, tcache, None,
                                        torch.from_numpy(t), tcfg)
            np.testing.assert_allclose(_f32(tl)[[0, 2]], _f32(jl)[[0, 2]],
                                       atol=tol["logits"])
    assert tcache.lengths.tolist() == np.asarray(jcache.lengths).tolist() \
        == [P + 4, 0, P + 4]


def _port_loss_and_grads(tp, batch, tcfg, remat=False):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(tp)]
    loss, aux = lm.loss_fn(tree_unflatten(tp, leaves), batch, tcfg,
                           remat=remat)
    return loss.detach(), aux, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_every_grad_leaf_match_jax(dtype):
    """CE chunks of 5 over 8 + 11 positions (the last padded), the 8
    patch positions and two text positions labelled -1; remat on in the
    bf16 case."""
    jcfg, tcfg, jp, tp = _pair(dtype, ce_chunk=5)
    toks, labels, (jfe, tfe) = _inputs(tcfg)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, jcfg), has_aux=True))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
             "frontend_embeds": jfe})
    loss, aux, grads = _port_loss_and_grads(
        tp, {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels), "frontend_embeds": tfe},
        tcfg, remat=dtype == "bfloat16")
    tol = TOL[dtype]
    assert abs(float(loss) - float(jloss)) <= tol["loss"] * \
        max(1.0, abs(float(jloss)))
    assert float(aux["aux"]) == 0.0
    jg = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jg)
    for got, want in zip(grads, jg):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol["atol"],
                                   rtol=tol["rtol"])
    # frontend_proj is the one leaf only the patches reach: its gradient
    # is live
    at = next(i for i, t in enumerate(tree_leaves(tp))
              if t is tp["frontend_proj"]["w"])
    assert float(grads[at].abs().sum()) > 0


def test_patch_positions_carry_no_loss():
    """The loss with patches is the mean CE of the text positions alone,
    computed from ``forward``'s hidden state by hand."""
    _, tcfg, _, tp = _pair("float32")
    toks, labels, (_, tfe) = _inputs(tcfg)
    t, lab = torch.from_numpy(toks), torch.from_numpy(labels)
    with torch.no_grad():
        loss, _ = lm.loss_fn(tp, {"tokens": t, "labels": lab,
                                  "frontend_embeds": tfe}, tcfg)
        hidden, _, _ = lm.forward(tp, t, tcfg, frontend_embeds=tfe)
        logits = hidden[:, 8:] @ tp["lm_head"]["table"].T
        want = torch.nn.functional.cross_entropy(
            logits.reshape(-1, tcfg.vocab_size), lab.reshape(-1).long(),
            ignore_index=-1)
    torch.testing.assert_close(loss, want, atol=1e-5, rtol=1e-5)


def test_train_cli_feeds_the_patches(monkeypatch):
    """``launch/train.py``'s ``run`` on reduced InternVL2 in f32, 2 nodes,
    2 SGWU rounds: every local step's batch carries the first rows of one
    seeded draw of ``random_frontend_embeds`` (the run's seed), and its
    loss and every gradient leaf agree with the reference's ``loss_fn`` at
    the same params and batch."""
    cfg = dataclasses.replace(configs.get_reduced(ARCH), dtype="float32")
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), dtype="float32")
    seen, loss_fn = [], lm.loss_fn

    def recording(params, batch, c, **kw):
        if torch.is_grad_enabled():
            seen.append((params_to_numpy(params),
                         {k: v.detach().clone() for k, v in batch.items()}))
        return loss_fn(params, batch, c, **kw)
    monkeypatch.setattr(lm, "loss_fn", recording)
    args = train.make_parser().parse_args(
        ["--arch", ARCH, "--device", "cpu", "--outer", "sgwu", "--nodes",
         "2", "--rounds", "2", "--local-steps", "1", "--rows", "16",
         "--seq-len", "8", "--batch-size", "4", "--seed", "3"])
    report = train.run(args, cfg)
    monkeypatch.setattr(lm, "loss_fn", loss_fn)
    assert np.isfinite(report.losses).all() and len(seen) >= 4
    want = frontends.random_frontend_embeds(
        torch.Generator().manual_seed(3), cfg, 4, device="cpu")
    jfn = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(p, b, jcfg),
                                     has_aux=True))
    for tree, batch in seen:
        fe = batch["frontend_embeds"]
        assert torch.equal(fe, want[:batch["tokens"].shape[0]])
        tp = params_from_numpy(tree, cfg, "cpu")
        loss, _, grads = _port_loss_and_grads(tp, batch, cfg)
        jb = {"tokens": jnp.asarray(batch["tokens"].numpy()),
              "labels": jnp.asarray(batch["labels"].numpy()),
              "frontend_embeds": jnp.asarray(fe.float().numpy(),
                                             jnp.bfloat16)}
        (jloss, _), jgrads = jfn(jax.tree_util.tree_map(jnp.asarray, tree),
                                 jb)
        assert abs(float(loss) - float(jloss)) <= 2e-5 * max(1.0,
                                                             float(jloss))
        for got, w in zip(grads, jax.tree_util.tree_leaves(jgrads)):
            np.testing.assert_allclose(_f32(got), _f32(w), atol=2e-5,
                                       rtol=1e-4)
