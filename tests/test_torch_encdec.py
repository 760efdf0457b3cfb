"""The encoder-decoder of the port (``repro_torch.models.encdec``) and the
step makers (``repro_torch.launch.steps``) against ``repro.models.encdec``
and ``repro.launch.steps`` on reduced SeamlessM4T-v2 (2 + 2 layers, d 128,
16 frames), on the CPU, from the same numpy params and seeded numpy
inputs: ``embed_tokens``, ``encode``, ``_decode_stack`` and
``encdec_forward``, ``encdec_loss_fn`` and every gradient leaf, the cache
layout, ``encdec_decode_step`` against a cross cache filled from the
memory through each layer's ``wk`` / ``wv``, and the decode of a text
prefix one token at a time against ``_decode_stack``'s logits at every
position (first in the reference, then in the port); then the makers'
train, prefill and decode steps, the abstract specs on the ``meta``
device, ``enc_len`` / ``text_len``, and the refusals of the serving
engine and the training CLI (``launch/train.py``), which serve and train
decoder-only archs, as the reference's do.

Tolerances: ``tests/test_torch_lm.py``'s (f32 hidden and logits 1e-4,
caches 1e-5; bf16 0.05 and 0.08) and ``tests/test_torch_lm_train.py``'s
(f32 loss 2e-5, gradients atol 2e-5 / rtol 1e-4; bf16 loss 5e-3,
gradients atol / rtol 3e-2).  The decode-against-prefix check holds the
reference to the same bars (seen: 4.5e-7 in f32, 7.1e-3 in bf16).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro_torch import configs, serving  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import encdec, layers  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

ARCH = "seamless-m4t-large-v2"
TOL = {"float32": {"out": 1e-4, "cache": 1e-5, "loss": 2e-5,
                   "atol": 2e-5, "rtol": 1e-4},
       "bfloat16": {"out": 0.05, "cache": 0.08, "loss": 5e-3,
                    "atol": 3e-2, "rtol": 3e-2}}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, S, FRAMES = 2, 7, 16
DTYPES = ["float32", "bfloat16"]


def _pair(dtype, **kw):
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), dtype=dtype, **kw)
    tcfg = dataclasses.replace(configs.get_reduced(ARCH), dtype=dtype, **kw)
    jp = jencdec.init_encdec_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, tcfg, jp, params_from_numpy(tree, tcfg, device="cpu")


def _inputs(cfg, seed=1):
    """Seeded tokens, labels (two of them -1) and frame embeddings (jax
    bf16, torch bf16) of one f32 draw."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, 2] = labels[1, -1] = -1
    fe = (rng.standard_normal((B, FRAMES, cfg.d_model)) * 0.02
          ).astype(np.float32)
    return toks, labels, (jnp.asarray(fe, jnp.bfloat16),
                          torch.from_numpy(fe).to(torch.bfloat16))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol,
                               err_msg=what)


_jencode = jax.jit(jencdec.encode, static_argnums=2)
_jstack = jax.jit(jencdec._decode_stack, static_argnums=3)
_jdecode = jax.jit(jencdec.encdec_decode_step, static_argnums=4)


def test_init_encdec_params_layout_matches_jax():
    cfg = configs.get_reduced(ARCH)
    meta = encdec.init_encdec_params(cfg, None, device="meta")
    jp = jax.eval_shape(lambda k: jencdec.init_encdec_params(
        k, jconfigs.get_reduced(ARCH)), jax.random.PRNGKey(0))
    got = [tuple(t.shape) for t in tree_leaves(meta)]
    assert got == [x.shape for x in jax.tree_util.tree_leaves(jp)]
    assert meta["encoder"]["mlp"]["wi"]["w"].shape == (2, 128, 256)
    p = encdec.init_encdec_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    q = encdec.init_encdec_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                 tree_leaves(q)))
    with pytest.raises(TypeError):
        encdec.init_encdec_params(cfg, None, "cpu")


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_and_decode_stack_match_jax(dtype):
    jcfg, tcfg, jp, tp = _pair(dtype)
    toks, _, (jfe, tfe) = _inputs(tcfg)
    jmem = _jencode(jp, jfe, jcfg)
    jx = jencdec.embed_tokens(jp, jnp.asarray(toks), jcfg)
    jh = _jstack(jp, jx, jmem, jcfg)
    tol = TOL[dtype]["out"]
    with torch.inference_mode():
        tmem = encdec.encode(tp, tfe, tcfg)
        tx = encdec.embed_tokens(tp, torch.from_numpy(toks), tcfg)
        th = encdec._decode_stack(tp, tx, tmem, tcfg)
        tf = encdec.encdec_forward(tp, tfe, torch.from_numpy(toks), tcfg)
    assert tmem.shape == (B, FRAMES, tcfg.d_model)
    assert tmem.dtype == tx.dtype == DT[dtype][1]
    _close(tx, jx, 0.0, "embed_tokens")
    _close(tmem, jmem, tol, "encode")
    _close(th, jh, tol, "_decode_stack")
    assert torch.equal(tf, th)


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_every_grad_leaf_match_jax(dtype):
    """CE chunks of 3 over 7 positions (the last padded), two labels -1."""
    jcfg, tcfg, jp, tp = _pair(dtype, ce_chunk=3)
    toks, labels, (jfe, tfe) = _inputs(tcfg)
    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jencdec.encdec_loss_fn(p, b, jcfg), has_aux=True))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
             "frontend_embeds": jfe})
    leaves = [p.detach().requires_grad_() for p in tree_leaves(tp)]
    loss, parts = encdec.encdec_loss_fn(
        tree_unflatten(tp, leaves),
        {"tokens": torch.from_numpy(toks),
         "labels": torch.from_numpy(labels), "frontend_embeds": tfe}, tcfg)
    grads = torch.autograd.grad(loss, leaves)
    tol = TOL[dtype]
    assert abs(float(loss.detach()) - float(jloss)) <= tol["loss"] * \
        max(1.0, abs(float(jloss)))
    assert float(parts["aux"]) == float(jparts["aux"]) == 0.0
    jg = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jg)
    for got, want in zip(grads, jg):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol["atol"],
                                   rtol=tol["rtol"])
        assert float(got.abs().sum()) > 0    # frontend_proj's too


def test_init_encdec_cache_layout_matches_jax():
    cfg = configs.get_reduced(ARCH)
    got = encdec.init_encdec_cache(cfg, 3, 12, FRAMES, device="cpu")
    want = jencdec.init_encdec_cache(jconfigs.get_reduced(ARCH), 3, 12,
                                     FRAMES)
    assert sorted(got) == sorted(want) == ["cross_k", "cross_v", "kv"]
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.bfloat16
        assert not bool(a.any())


def _filled(jp, tp, jcfg, tcfg, jmem, tmem, jdt, tdt, max_seq):
    """Both packages' caches with cross_k / cross_v projected from each
    package's memory through every decoder layer's cross wk / wv."""
    L, KH, D = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim
    jc = jencdec.init_encdec_cache(jcfg, B, max_seq, FRAMES, dtype=jdt)
    tc = encdec.init_encdec_cache(tcfg, B, max_seq, FRAMES, dtype=tdt,
                                  device="cpu")
    xa = jp["decoder"]["cross_attn"]
    jc = dict(jc, **{f"cross_{n}": jnp.stack([
        (jmem @ xa[f"w{n}"]["w"][i].astype(jmem.dtype)).reshape(
            B, FRAMES, KH, D) for i in range(L)]).astype(jdt)
        for n in ("k", "v")})
    ta = tp["decoder"]["cross_attn"]
    for n in ("k", "v"):
        for i in range(L):
            tc[f"cross_{n}"][i] = layers.dense(
                {"w": ta[f"w{n}"]["w"][i]}, tmem).reshape(
                B, FRAMES, KH, D).to(tdt)
    return jc, tc


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_steps_match_jax(dtype):
    """4 decode steps at cache_len 0..3 against cross K/V filled from the
    reference's memory in both packages: the logits, the self-attention
    cache (written in place: the returned cache is the one given) and
    the untouched cross K/V."""
    jcfg, tcfg, jp, tp = _pair(dtype)
    jdt, tdt = DT[dtype]
    toks, _, (jfe, _) = _inputs(tcfg)
    jmem = _jencode(jp, jfe, jcfg)
    tmem = torch.from_numpy(_f32(jmem).copy()).to(tdt)
    jc, tc = _filled(jp, tp, jcfg, tcfg, jmem, tmem, jdt, tdt, 8)
    tol = TOL[dtype]
    with torch.inference_mode():
        for t in range(4):
            jl, jc = _jdecode(jp, jc, t, jnp.asarray(toks[:, t:t + 1]), jcfg)
            tl, out = encdec.encdec_decode_step(
                tp, tc, t, torch.from_numpy(toks[:, t:t + 1]), tcfg)
            assert out is tc and tl.shape == (B, 1, tcfg.vocab_size)
            _close(tl, jl, tol["out"], f"logits, step {t}")
    for name, got in (("k", tc["kv"]["k"]), ("v", tc["kv"]["v"]),
                      ("cross_k", tc["cross_k"])):
        want = jc["kv"][name] if name in ("k", "v") else jc[name]
        _close(got, want, tol["cache"], name)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_of_a_prefix_matches_the_decode_stack(dtype):
    """The text prefix decoded one token at a time against the cross
    cache filled from the memory gives ``_decode_stack``'s logits at
    every position: first in the reference, then in the port (against
    its own stack and against the reference's)."""
    jcfg, tcfg, jp, tp = _pair(dtype)
    jdt, tdt = DT[dtype]
    toks, _, (jfe, tfe) = _inputs(tcfg)
    tol = TOL[dtype]["out"]

    jmem = _jencode(jp, jfe, jcfg)
    jh = _jstack(jp, jencdec.embed_tokens(jp, jnp.asarray(toks), jcfg),
                 jmem, jcfg)
    jwant = (jh @ jp["embed"]["table"].astype(jh.dtype).T).astype(
        jnp.float32)
    with torch.inference_mode():
        tmem = encdec.encode(tp, tfe, tcfg)
        th = encdec._decode_stack(
            tp, encdec.embed_tokens(tp, torch.from_numpy(toks), tcfg),
            tmem, tcfg)
        twant = (th @ tp["embed"]["table"].to(th.dtype).T).float()
    jc, tc = _filled(jp, tp, jcfg, tcfg, jmem, tmem, jdt, tdt, S)
    with torch.inference_mode():
        for t in range(S):
            jl, jc = _jdecode(jp, jc, t, jnp.asarray(toks[:, t:t + 1]), jcfg)
            _close(jl[:, 0], jwant[:, t], tol, f"reference, position {t}")
            tl, tc = encdec.encdec_decode_step(
                tp, tc, t, torch.from_numpy(toks[:, t:t + 1]), tcfg)
            _close(tl[:, 0], twant[:, t], tol, f"port, position {t}")
            _close(tl[:, 0], jwant[:, t], 2 * tol, f"port vs reference {t}")


# ----------------------------------------------------------------------
# launch/steps.py
# ----------------------------------------------------------------------
NEW_ARCHS = ("seamless-m4t-large-v2", "internvl2-26b", "stablelm-12b")


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", NEW_ARCHS + ("yi-6b",))
def test_input_specs_and_lengths_match_jax(arch, shape):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    sh, jsh = configs.get_shape(shape), jconfigs.get_shape(shape)
    assert dataclasses.asdict(sh) == dataclasses.asdict(jsh)
    assert steps.enc_len(cfg, sh) == jsteps.enc_len(jcfg, jsh)
    assert steps.text_len(cfg, sh) == jsteps.text_len(jcfg, jsh)
    got, want = steps.input_specs(cfg, sh), jsteps.input_specs(jcfg, jsh)
    assert sorted(got) == sorted(want)
    for k, spec in got.items():
        assert spec.device.type == "meta"
        assert tuple(spec.shape) == want[k].shape, k
        assert str(spec.dtype).split(".")[-1] == want[k].dtype.name, k


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_abstract_params_opt_state_and_cache_match_jax(arch):
    cfg = configs.get_reduced(arch)
    jcfg = jconfigs.get_reduced(arch)
    sh = configs.get_shape("decode_32k")
    for got, want in (
            (steps.abstract_params(cfg), jsteps.abstract_params(jcfg)),
            (steps.abstract_opt_state(cfg),
             jsteps.abstract_opt_state(jcfg)),
            (steps.abstract_cache(cfg, sh),
             jsteps.abstract_cache(jcfg, jconfigs.get_shape("decode_32k")))):
        if not isinstance(got, dict):        # a DecodeCache
            got = {"layers": got.layers, "lengths": got.lengths}
            want = {"layers": want.layers, "lengths": want.lengths}
        g = tree_leaves(got)
        w = jax.tree_util.tree_leaves(want)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.device.type == "meta"
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).split(".")[-1] == b.dtype.name


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-26b"])
def test_train_step_matches_jax(arch):
    """Two steps of ``make_train_step`` (clip 1.0) in f32 from the same
    params and batch: the loss and grad norm of each step and every param
    after them.  SGD at lr 0.5, so that the params carry the gradients'
    agreement: AdamW's normalised step would turn an element's rounding
    difference in a near-zero gradient into a difference of up to lr
    (``tests/test_torch_train_cli.py`` says more)."""
    f32 = dict(dtype="float32", ce_chunk=4)
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), **f32)
    tcfg = dataclasses.replace(configs.get_reduced(arch), **f32)
    if arch == ARCH:
        jp = jencdec.init_encdec_params(jax.random.PRNGKey(0), jcfg)
    else:
        from repro.models import lm as jlm
        jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           "cpu")
    toks, labels, (jfe, tfe) = _inputs(tcfg)
    if arch != ARCH:     # the patches, as many as the config takes
        P = tcfg.num_frontend_tokens
        jfe, tfe = jfe[:, :P], tfe[:, :P]
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "frontend_embeds": jfe}
    tb = {"tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(labels), "frontend_embeds": tfe}
    from repro.optim.optimizers import make_optimizer as jopt
    from repro_torch.optim.optimizers import make_optimizer
    jstep = jax.jit(jsteps.make_train_step(jcfg, "sgd", learning_rate=0.5))
    tstep = steps.make_train_step(tcfg, "sgd", learning_rate=0.5)
    js, ts = jopt("sgd").init(jp), make_optimizer("sgd").init(tp)
    for _ in range(2):
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        for k in ("loss", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) <= 2e-5 * max(
                1.0, abs(float(jm[k]))), k
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-5, rtol=1e-3)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_makers_match_jax(dtype):
    """The encoder-decoder's prefill (the last position's hidden state,
    no cache) and decode step from the makers."""
    jcfg, tcfg, jp, tp = _pair(dtype)
    jdt, tdt = DT[dtype]
    toks, _, (jfe, tfe) = _inputs(tcfg)
    tol = TOL[dtype]["out"]
    jlast = jax.jit(jsteps.make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(toks), "frontend_embeds": jfe})
    with torch.inference_mode():
        tlast = steps.make_prefill_step(tcfg)(
            tp, {"tokens": torch.from_numpy(toks), "frontend_embeds": tfe})
    assert tlast.shape == (B, tcfg.d_model)
    _close(tlast, jlast, tol, "prefill")
    jmem = _jencode(jp, jfe, jcfg)
    jc, tc = _filled(jp, tp, jcfg, tcfg, jmem,
                     torch.from_numpy(_f32(jmem).copy()).to(tdt), jdt, tdt, 4)
    jl, _ = jax.jit(jsteps.make_decode_step(jcfg))(
        jp, jc, jnp.int32(0), {"tokens": jnp.asarray(toks[:, :1])})
    with torch.inference_mode():
        tl, _ = steps.make_decode_step(tcfg)(
            tp, tc, 0, {"tokens": torch.from_numpy(toks[:, :1])})
    _close(tl, jl, tol, "decode")


def test_serving_and_the_train_cli_refuse_encdec():
    """As in the reference: the slot-major serving cache and the LM
    training CLI take decoder-only archs."""
    cfg = configs.get_reduced(ARCH)
    with pytest.raises(ValueError, match="encdec"):
        serving.resolve_serve_engine(cfg)
    args = train.make_parser().parse_args(["--arch", ARCH, "--device",
                                           "cpu"])
    with pytest.raises(SystemExit):
        train.run(args, cfg)


def test_value_and_grad_frees_the_gradients_without_a_collection():
    """A training step's gradients die with the tree that holds them, with
    the garbage collector off: ``tree_unflatten`` makes no reference
    cycle (a recursive closure did, and its iterator held the whole
    gradient tuple until the next collection, several gradient trees at
    once over a loop of steps)."""
    import gc
    import weakref
    from repro_torch.core.bpt_trainer import value_and_grad
    _, tcfg, _, tp = _pair("float32")
    toks, labels, (_, tfe) = _inputs(tcfg)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels), "frontend_embeds": tfe}
    gc.collect()
    gc.disable()
    try:
        _, grads = value_and_grad(
            lambda p, b: encdec.encdec_loss_fn(p, b, tcfg), tp, batch)
        refs = [weakref.ref(g) for g in tree_leaves(grads)]
        del grads
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
