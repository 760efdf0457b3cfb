"""The port's LM (``repro_torch.models.lm``) against ``repro.models.lm``
on reduced Yi-6B and Phi-3: the same numpy params through both, then
``prefill`` logits and cache and several ``decode_step``s with per-row
lengths.

Tolerances: the f32 config runs an f32 cache and must agree to 1e-4 in
the logits and 1e-5 in the cache (sums in another order); the default
bf16 config is held to the JAX suite's own prefill-vs-decode bars
(``tests/test_serve.py``: logits atol 0.05, cache atol 0.08).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.types import ModelConfig  # noqa: E402
from repro_torch.models import blocks, layers  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.weights import params_from_numpy, params_to_numpy  # noqa: E402

ARCHS = ("yi-6b", "phi3-mini-3.8b")
TOL = {"float32": {"logits": 1e-4, "cache": 1e-5},
       "bfloat16": {"logits": 0.05, "cache": 0.08}}
CACHE_DT = {"float32": (jnp.float32, torch.float32),
            "bfloat16": (jnp.bfloat16, torch.bfloat16)}


# jitted reference calls: eager JAX compiles every op on every call
_jprefill = jax.jit(jlm.prefill, static_argnums=(2, 3))
_jdecode = jax.jit(lambda p, c, t, cfg: jlm.decode_step(p, c, None, t, cfg),
                   static_argnums=3)


def _pair(arch, dtype):
    """(jax cfg, port cfg, jax params, port params) from one numpy tree."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), dtype=dtype)
    tcfg = dataclasses.replace(configs.get_reduced(arch), dtype=dtype)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, tcfg, jp, params_from_numpy(tree, tcfg, device="cpu")


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, dtype):
    jcfg, tcfg, jp, tp = _pair(arch, dtype)
    jdt, tdt = CACHE_DT[dtype]
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    jl, jsl = _jprefill(jp, jnp.asarray(toks), jcfg, jdt)
    with torch.inference_mode():
        tl, tsl = lm.prefill(tp, torch.from_numpy(toks), tcfg,
                             cache_dtype=tdt)
    assert tl.dtype == torch.float32 and tl.shape == (2, 1, jcfg.vocab_size)
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=TOL[dtype]["logits"])
    assert tsl.lengths.tolist() == [11, 11]
    for leaf in ("k", "v"):
        got, want = tsl.layers["kv"][leaf], jsl.layers["kv"][leaf]
        assert got.dtype == tdt and tuple(got.shape) == want.shape
        np.testing.assert_allclose(_f32(got), _f32(want),
                                   atol=TOL[dtype]["cache"], err_msg=leaf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch, dtype):
    """Two prompts of different lengths in slots 0 and 2 (slot 1 free),
    then four decode steps: every occupied row decodes at its own
    position, only occupied lengths advance."""
    jcfg, tcfg, jp, tp = _pair(arch, dtype)
    jdt, tdt = CACHE_DT[dtype]
    rng = np.random.default_rng(2)
    prompts = {0: rng.integers(0, jcfg.vocab_size, (1, 5)).astype(np.int32),
               2: rng.integers(0, jcfg.vocab_size, (1, 9)).astype(np.int32)}
    jc = jlm.init_cache(3, 24, jcfg, dtype=jdt)
    tc = lm.init_cache(3, 24, tcfg, dtype=tdt)
    with torch.inference_mode():
        for slot, p in prompts.items():
            _, jsl = _jprefill(jp, jnp.asarray(p), jcfg, jdt)
            _, tsl = lm.prefill(tp, torch.from_numpy(p), tcfg,
                                cache_dtype=tdt)
            jc = jlm.cache_insert(jc, jsl, slot)
            tc = lm.cache_insert(tc, tsl, slot)
        for _ in range(4):
            t = rng.integers(0, jcfg.vocab_size, (3, 1)).astype(np.int32)
            jl, jc = _jdecode(jp, jc, jnp.asarray(t), jcfg)
            tl, tc = lm.decode_step(tp, tc, None, torch.from_numpy(t), tcfg)
            np.testing.assert_allclose(_f32(tl)[[0, 2]], _f32(jl)[[0, 2]],
                                       atol=TOL[dtype]["logits"])
            assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist()
    assert tc.lengths.tolist() == [9, 0, 13]
    for leaf in ("k", "v"):
        np.testing.assert_allclose(
            _f32(tc.layers["kv"][leaf])[:, [0, 2]],
            _f32(jc.layers["kv"][leaf])[:, [0, 2]],
            atol=TOL[dtype]["cache"], err_msg=leaf)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_matches_jax(arch):
    jcfg, tcfg, jp, tp = _pair(arch, "float32")
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 7)).astype(np.int32)
    jh, jcache, _ = jlm.forward(jp, jnp.asarray(toks), jcfg)
    th, tcache, aux = lm.forward(tp, torch.from_numpy(toks), tcfg)
    assert jcache is None and tcache is None and float(aux) == 0.0
    np.testing.assert_allclose(_f32(th), _f32(jh), atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_matches_jax(arch):
    """Same tree, shapes and dtypes as the reference's init."""
    cfg = configs.get_reduced(arch)
    shapes = jax.eval_shape(lambda k: jlm.init_params(k, jconfigs.get_reduced(
        arch)), jax.random.PRNGKey(0))
    want = jax.tree_util.tree_map(lambda s: (tuple(s.shape), str(s.dtype)),
                                  shapes)
    ours = lm.init_params(cfg, torch.Generator("cpu").manual_seed(0),
                          device="cpu")
    got = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                 params_to_numpy(ours))
    assert got == want


def test_init_params_is_seeded_and_explicit():
    cfg = configs.get_reduced("yi-6b")
    a = lm.init_params(cfg, torch.Generator("cpu").manual_seed(5), "cpu")
    b = lm.init_params(cfg, torch.Generator("cpu").manual_seed(5), "cpu")
    assert torch.equal(a["layers"]["mlp"]["wo"]["w"],
                       b["layers"]["mlp"]["wo"]["w"])
    with pytest.raises(TypeError):
        lm.init_params(cfg, None, "cpu")


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_params(configs.get_reduced("yi-6b"),
                       torch.Generator("cpu").manual_seed(0))


def test_params_from_numpy_rejects_bad_trees():
    cfg = configs.get_reduced("yi-6b")
    tree = params_to_numpy(lm.init_params(
        cfg, torch.Generator("cpu").manual_seed(0), "cpu"))
    tree["layers"]["attn"]["wq"]["w"] = tree["layers"]["attn"]["wq"]["w"].T
    with pytest.raises(ValueError, match="wq"):
        params_from_numpy(tree, cfg, "cpu")
    del tree["lm_head"]
    with pytest.raises(ValueError, match="lm_head"):
        params_from_numpy(tree, cfg, "cpu")


@pytest.mark.parametrize("theta", [10_000.0, 5_000_000.0])
@pytest.mark.parametrize("head_dim", [32, 96, 128])
def test_rope_matches_jax(theta, head_dim):
    from repro.models import layers as jlayers
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 3, head_dim)).astype(np.float32)
    pos = np.tile(np.arange(6, dtype=np.int32) * 17, (2, 1))
    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         theta))
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            theta).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def _tiny(**kw):
    base = dict(name="t", arch_type="dense", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                vocab_size=128)
    base.update(kw)
    return ModelConfig(**base)


@pytest.mark.parametrize("kw,branch", [
    (dict(sliding_window=8, window_pattern=2), "sliding_window"),
    (dict(qk_norm=True), "qk_norm"),
    (dict(attn_softcap=50.0), "attn_softcap"),
    (dict(final_softcap=30.0), "final_softcap"),
    (dict(post_norm=True), "post_norm"),
    (dict(embed_onehot=True), "embed_onehot"),
    (dict(arch_type="moe", num_experts=4, top_k=2, expert_d_ff=64), "moe"),
    (dict(arch_type="ssm"), "ssm"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_unported_branches_raise(kw, branch):
    cfg = _tiny(**kw)
    with pytest.raises(NotImplementedError, match=branch):
        blocks.check_supported(cfg)
    with pytest.raises(NotImplementedError, match=branch):
        lm.init_params(cfg, torch.Generator("cpu").manual_seed(0), "cpu")
