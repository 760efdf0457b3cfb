"""StableLM-2-12B's config (head_dim 160) and the reference's embedding and
attention flags in the port, against the JAX package on the CPU: the three
new configs and their variants field for field; a narrow dense config at
head_dim 160 (d 320, 2 q heads, 1 kv head, 2 layers) through ``prefill``,
4 decode steps and ``loss_fn`` with every gradient leaf, from the same
numpy params; the rotary embedding at head_dim 160; ``embed_onehot``,
``embed_reshard`` and ``attn_kv_gather`` each on, against the reference
with the flag on and against the port with it off (bit for bit: they
change sharding or pick the same rows); the ``opt`` variant equal to the
plain config; and ``check_supported`` admitting what the reference's
block dispatch admits.

Tolerances: ``tests/test_torch_lm.py``'s (f32 logits 1e-4, caches 1e-5;
bf16 0.05 and 0.08) and ``tests/test_torch_lm_train.py``'s (f32 loss
2e-5, gradients atol 2e-5 / rtol 1e-4; bf16 loss 5e-3, gradients atol /
rtol 3e-2); the rotary embedding at ``test_torch_lm.py``'s 1e-5.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.core.types import ModelConfig  # noqa: E402
from repro_torch.models import blocks, layers, lm  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

ARCH = "stablelm-12b"
NEW_ARCHS = ("stablelm-12b", "internvl2-26b", "seamless-m4t-large-v2")
NARROW = dict(d_model=320, num_heads=2, num_kv_heads=1, head_dim=160,
              d_ff=640)
TOL = {"float32": {"logits": 1e-4, "cache": 1e-5, "loss": 2e-5,
                   "atol": 2e-5, "rtol": 1e-4},
       "bfloat16": {"logits": 0.05, "cache": 0.08, "loss": 5e-3,
                    "atol": 3e-2, "rtol": 3e-2}}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FLAGS = ("embed_onehot", "embed_reshard", "attn_kv_gather")


def _pair(dtype, **kw):
    """(jax cfg, port cfg, jax params, port params): the narrow config at
    head_dim 160 with ``kw`` replaced, from one numpy tree."""
    kw = dict(NARROW, dtype=dtype, **kw)
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), **kw)
    tcfg = dataclasses.replace(configs.get_reduced(ARCH), **kw)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, tcfg, jp, params_from_numpy(tree, tcfg, device="cpu")


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_match_jax(arch):
    for get in ("get_config", "get_reduced"):
        got = getattr(configs, get)(arch)
        want = getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), get
        assert got.param_count() == want.param_count()
    for variant in ("swa", "opt"):
        assert dataclasses.asdict(configs.get_config(arch, variant)) == \
            dataclasses.asdict(jconfigs.get_config(arch, variant))


def test_stablelm_is_dense_at_head_dim_160():
    cfg = configs.get_config(ARCH)
    assert (cfg.arch_type, cfg.num_layers, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        ("dense", 40, 5120, 32, 8, 160, 13824, 100352)
    meta = lm.init_params(dataclasses.replace(cfg, num_layers=1), None,
                          device="meta")
    assert meta["layers"]["attn"]["wk"]["w"].shape == (1, 5120, 1280)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """Prompts of 5 and 19 tokens in slots 0 and 2 of a 3-slot cache,
    then 4 decode steps: the prefill logits and cache, every decode
    step's logits and the final cache of the occupied slots."""
    jcfg, tcfg, jp, tp = _pair(dtype)
    jdt, tdt = DT[dtype]
    tol = TOL[dtype]
    rng = np.random.default_rng(2)
    jprefill = jax.jit(jlm.prefill, static_argnums=(2, 3))
    jdecode = jax.jit(lambda p, c, t: jlm.decode_step(p, c, None, t, jcfg))
    jc = jlm.init_cache(3, 32, jcfg, dtype=jdt)
    tc = lm.init_cache(3, 32, tcfg, dtype=tdt, device="cpu")
    with torch.inference_mode():
        for slot, n in ((0, 5), (2, 19)):
            p = rng.integers(0, jcfg.vocab_size, (1, n)).astype(np.int32)
            jl, jsl = jprefill(jp, jnp.asarray(p), jcfg, jdt)
            tl, tsl = lm.prefill(tp, torch.from_numpy(p), tcfg,
                                 cache_dtype=tdt)
            np.testing.assert_allclose(_f32(tl), _f32(jl),
                                       atol=tol["logits"])
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    _f32(tsl.layers["kv"][name]),
                    _f32(jsl.layers["kv"][name]), atol=tol["cache"])
            jc = jlm.cache_insert(jc, jsl, slot)
            tc = lm.cache_insert(tc, tsl, slot)
        for _ in range(4):
            t = rng.integers(0, jcfg.vocab_size, (3, 1)).astype(np.int32)
            jl, jc = jdecode(jp, jc, jnp.asarray(t))
            tl, tc = lm.decode_step(tp, tc, None, torch.from_numpy(t), tcfg)
            np.testing.assert_allclose(_f32(tl)[[0, 2]], _f32(jl)[[0, 2]],
                                       atol=tol["logits"])
    assert tc.lengths.tolist() == [9, 0, 23]
    for name in ("k", "v"):
        np.testing.assert_allclose(_f32(tc.layers["kv"][name])[:, [0, 2]],
                                   _f32(jc.layers["kv"][name])[:, [0, 2]],
                                   atol=tol["cache"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_every_grad_leaf_match_jax(dtype):
    jcfg, tcfg, jp, tp = _pair(dtype, ce_chunk=5)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    labels[0, 3] = labels[1, -1] = -1
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, jcfg), has_aux=True))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    leaves = [p.detach().requires_grad_() for p in tree_leaves(tp)]
    loss, _ = lm.loss_fn(tree_unflatten(tp, leaves),
                         {"tokens": torch.from_numpy(toks),
                          "labels": torch.from_numpy(labels)}, tcfg)
    grads = torch.autograd.grad(loss, leaves)
    tol = TOL[dtype]
    assert abs(float(loss.detach()) - float(jloss)) <= \
        tol["loss"] * max(1.0, abs(float(jloss)))
    jg = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jg)
    for got, want in zip(grads, jg):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol["atol"],
                                   rtol=tol["rtol"])


def test_rope_at_head_dim_160_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 3, 160)).astype(np.float32)
    pos = np.tile(np.arange(6, dtype=np.int32) * 331, (2, 1))
    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         10_000.0))
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            10_000.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flag", FLAGS)
def test_flags_give_the_reference_values(flag, dtype):
    """Each flag on: the port's forward hidden state against the
    reference's with the flag on, and bit for bit against the port's with
    it off."""
    jcfg, tcfg, jp, tp = _pair(dtype, **{flag: True})
    toks = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, 9)).astype(np.int32)
    jh, _, _ = jax.jit(lambda p, t: jlm.forward(p, t, jcfg))(
        jp, jnp.asarray(toks))
    with torch.inference_mode():
        th, _, _ = lm.forward(tp, torch.from_numpy(toks), tcfg)
        plain, _, _ = lm.forward(tp, torch.from_numpy(toks),
                                 dataclasses.replace(tcfg, **{flag: False}))
    np.testing.assert_allclose(_f32(th), _f32(jh),
                               atol=TOL[dtype]["logits"])
    assert torch.equal(th, plain)


def test_embed_onehot_is_the_row_lookup():
    """The reference's one-hot product, ``one_hot(tokens) @ table`` in the
    activation dtype, equals the looked-up rows cast to it."""
    rng = np.random.default_rng(6)
    table = rng.standard_normal((50, 24)).astype(np.float32)
    toks = rng.integers(0, 50, (3, 7)).astype(np.int32)
    for jdt, tdt in DT.values():
        oh = jax.nn.one_hot(jnp.asarray(toks), 50, dtype=jdt)
        want = _f32(oh @ jnp.asarray(table).astype(jdt))
        got = layers.embed({"table": torch.from_numpy(table)},
                           torch.from_numpy(toks)).to(tdt)
        np.testing.assert_array_equal(_f32(got), want)


def test_opt_variant_equals_the_plain_config():
    """``get_config(arch, "opt")`` turns on ``attn_kv_gather`` (and
    ``attn_block_skip`` where a window is set): the port's forward and
    decode step equal the plain config's, bit for bit."""
    opt = configs.get_config(ARCH, "opt")
    assert opt.attn_kv_gather and not opt.attn_block_skip
    kw = dict(NARROW, dtype="float32")
    plain = dataclasses.replace(configs.get_reduced(ARCH), **kw)
    varied = dataclasses.replace(plain, attn_kv_gather=opt.attn_kv_gather,
                                 attn_block_skip=opt.attn_block_skip)
    params = lm.init_params(plain, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, plain.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    with torch.inference_mode():
        for name, cfg in (("plain", plain), ("opt", varied)):
            logits, sl = lm.prefill(params, toks, cfg,
                                    cache_dtype=torch.float32)
            cache = lm.init_cache(2, 12, cfg, dtype=torch.float32,
                                  device="cpu")
            for row in range(2):
                lm.cache_insert(cache, sl, row, row)
            step, _ = lm.decode_step(params, cache, None, toks[:, :1], cfg)
            out[name] = (logits, step)
    assert all(torch.equal(a, b) for a, b in zip(out["plain"], out["opt"]))


@pytest.mark.parametrize("arch_type", ["vlm", "audio", "encdec"])
def test_check_supported_admits_the_reference_dispatch(arch_type):
    cfg = ModelConfig(name="t", arch_type=arch_type, num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                      d_ff=128, vocab_size=128, embed_onehot=True,
                      embed_reshard=True, attn_kv_gather=True)
    blocks.check_supported(cfg)
    p = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert sorted(p["layers"]) == ["attn", "ln1", "ln2", "mlp"]
    assert arch_type in blocks.BLOCK_ARCHS
