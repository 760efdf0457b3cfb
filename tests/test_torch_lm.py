"""The port's LM (``repro_torch.models.lm``) against ``repro.models.lm``
on reduced Yi-6B, Phi-3, Gemma-2 (local/global windows, soft-caps,
post-norms), Yi-6B with sliding windows on every layer, the MoE family
(Qwen3-MoE with ``qk_norm``, Granite-MoE), Mamba2 (the ssm block) and
Hymba (the hybrid block, window 16 on layer 1): the same numpy params
through both, then ``prefill`` logits and every cache leaf and several
``decode_step``s with per-row lengths, and one prefill long enough for
two key chunks of the blockwise attention.

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
from repro_torch.models import attention, blocks, layers  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.weights import params_from_numpy, params_to_numpy  # noqa: E402

# "yi-6b:swa": reduced Yi-6B under get_config(..., "swa")-style windows
# (every layer local), the window cut to 8 as the reduced configs cut it
ARCHS = ("yi-6b", "phi3-mini-3.8b", "gemma2-27b", "yi-6b:swa",
         "qwen3-moe-30b-a3b", "granite-moe-3b-a800m", "mamba2-370m",
         "hymba-1.5b")
SWA = dict(sliding_window=8, window_pattern=0, global_layers=())
TOL = {"float32": {"logits": 1e-4, "cache": 1e-5},
       "bfloat16": {"logits": 0.05, "cache": 0.08}}
CACHE_DT = {"float32": (jnp.float32, torch.float32),
            "bfloat16": (jnp.bfloat16, torch.bfloat16)}


# jitted reference calls: eager JAX compiles every op on every call
_jprefill = jax.jit(jlm.prefill, static_argnums=(2, 3))
_jdecode = jax.jit(lambda p, c, t, cfg: jlm.decode_step(p, c, None, t, cfg),
                   static_argnums=3)


def _reduced(pkg, arch, **kw):
    name, _, variant = arch.partition(":")
    cfg = pkg.get_reduced(name)
    if variant == "swa":
        cfg = dataclasses.replace(cfg, **SWA)
    return dataclasses.replace(cfg, **kw)


def _pair(arch, dtype):
    """(jax cfg, port cfg, jax params, port params) from one numpy tree."""
    jcfg = _reduced(jconfigs, arch, dtype=dtype)
    tcfg = _reduced(configs, arch, dtype=dtype)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, tcfg, jp, params_from_numpy(tree, tcfg, device="cpu")


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _cache_leaves(got, want, path=()):
    """(name, port leaf, reference leaf) for every leaf of two cache
    trees of one structure: kv's k and v, the mixer's ssm and conv."""
    assert set(got) == set(want), path
    for k in sorted(got):
        if isinstance(got[k], dict):
            yield from _cache_leaves(got[k], want[k], path + (k,))
        else:
            yield "/".join(path + (k,)), got[k], want[k]


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
    for leaf, got, want in _cache_leaves(tsl.layers, jsl.layers):
        # the mixer's state is f32 whatever the cache's dtype
        assert got.dtype == (torch.float32 if leaf.endswith("ssm") else tdt)
        assert tuple(got.shape) == want.shape
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
    # slot 2's prompt and its decode positions pass the windows (8, 16)
    prompts = {0: rng.integers(0, jcfg.vocab_size, (1, 5)).astype(np.int32),
               2: rng.integers(0, jcfg.vocab_size, (1, 19)).astype(np.int32)}
    jc = jlm.init_cache(3, 32, jcfg, dtype=jdt)
    tc = lm.init_cache(3, 32, tcfg, dtype=tdt, device="cpu")
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
    assert tc.lengths.tolist() == [9, 0, 23]
    for leaf, got, want in _cache_leaves(tc.layers, jc.layers):
        np.testing.assert_allclose(_f32(got)[:, [0, 2]],
                                   _f32(want)[:, [0, 2]],
                                   atol=TOL[dtype]["cache"], err_msg=leaf)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_matches_jax(arch):
    jcfg, tcfg, jp, tp = _pair(arch, "float32")
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 21)).astype(np.int32)
    jh, jcache, jaux = jlm.forward(jp, jnp.asarray(toks), jcfg)
    th, tcache, aux = lm.forward(tp, torch.from_numpy(toks), tcfg)
    assert jcache is None and tcache is None
    assert aux.dtype == torch.float32
    if tcfg.arch_type == "moe":      # the layers' load-balance losses
        assert float(aux) > 0
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    else:
        assert float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(_f32(th), _f32(jh), atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_matches_jax(arch):
    """Same tree, shapes and dtypes as the reference's init."""
    cfg = _reduced(configs, arch)
    shapes = jax.eval_shape(lambda k: jlm.init_params(k, _reduced(
        jconfigs, arch)), jax.random.PRNGKey(0))
    want = jax.tree_util.tree_map(lambda s: (tuple(s.shape), str(s.dtype)),
                                  shapes)
    ours = lm.init_params(cfg, torch.Generator("cpu").manual_seed(0),
                          device="cpu")
    got = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                 params_to_numpy(ours))
    assert got == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_long_prefill_spans_two_key_chunks(dtype):
    """A 1100-token prompt: the blockwise attention walks three query
    chunks of 512 and two key chunks of 1024, on the local (window 16)
    and the global layer of reduced Gemma-2.

    The f32 k cache is held at 1e-4, not 1e-5: under ``jax.jit`` the
    reference's own rotary embedding drifts from its eager form as the
    position grows (4.7e-5 at positions 1000-1100 for |x| ~ 3, against
    1e-6 eager, which the port matches), and k is the rotated tensor.
    """
    jcfg, tcfg, jp, tp = _pair("gemma2-27b", dtype)
    tol = dict(TOL[dtype], **({"cache": 1e-4} if dtype == "float32" else {}))
    jdt, tdt = CACHE_DT[dtype]
    toks = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (1, 1100)).astype(np.int32)
    jl, jsl = _jprefill(jp, jnp.asarray(toks), jcfg, jdt)
    with torch.inference_mode():
        tl, tsl = lm.prefill(tp, torch.from_numpy(toks), tcfg,
                             cache_dtype=tdt)
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=tol["logits"])
    for leaf in ("k", "v"):
        np.testing.assert_allclose(_f32(tsl.layers["kv"][leaf]),
                                   _f32(jsl.layers["kv"][leaf]),
                                   atol=tol["cache"], err_msg=leaf)


@pytest.mark.parametrize("arch", ["gemma2-27b", "yi-6b:swa", "yi-6b"])
def test_layer_windows_match_jax(arch):
    from repro.models import blocks as jblocks
    for L in (2, 5, 8):
        want = np.asarray(jblocks.layer_windows(_reduced(jconfigs, arch), L))
        got = blocks.layer_windows(_reduced(configs, arch), L)
        assert list(got) == want.tolist()


def test_chunked_attention_matches_jax():
    """The blockwise attention alone, bf16, small chunks so that every
    query chunk walks several key chunks: window, soft-cap, GQA."""
    from repro.models import attention as jattn
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 70, 8, 16)).astype(np.float32)
    k = rng.standard_normal((2, 70, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 70, 2, 16)).astype(np.float32)
    kw = dict(causal=True, window=24, attn_softcap=50.0, q_chunk=16,
              k_chunk=32)
    want = jattn.chunked_attention(*(jnp.asarray(a, jnp.bfloat16)
                                     for a in (q, k, v)), **kw)
    got = attention.chunked_attention(*(torch.from_numpy(a).bfloat16()
                                        for a in (q, k, v)), **kw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=8e-2, rtol=2e-2)


@pytest.mark.parametrize("arch", ["yi-6b", "gemma2-27b"])
def test_compute_params_keeps_norm_scales(arch):
    """The serving copy casts weight matrices to bf16 and leaves every norm
    scale (1-D per layer, stacked (L, d)) in f32, as the reference's
    per-layer cast of >= 2-D leaves does."""
    cfg = configs.get_reduced(arch)
    params = lm.init_params(cfg, torch.Generator("cpu").manual_seed(0), "cpu")
    cp = lm.compute_params(params, cfg)
    for name in ("ln1", "ln2") + (("pn1", "pn2") if cfg.post_norm else ()):
        assert cp["layers"][name]["scale"].dtype == torch.float32, name
    assert cp["final_norm"]["scale"].dtype == torch.float32
    assert cp["layers"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert cp["layers"]["mlp"]["wo"]["w"].dtype == torch.bfloat16
    assert cp["embed"]["table"].dtype == torch.bfloat16


def test_init_cache_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_cache(2, 8, configs.get_reduced("yi-6b"))


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


# the ssm and hybrid cases became vlm and audio once those blocks were
# ported, and those and the flags became arch types with no LM block once
# every block of the reference's dispatch was: the count of cases stays,
# each on a branch still refused
@pytest.mark.parametrize("arch_type", ["cnn", "rnn", "", "Dense"])
def test_unported_branches_raise(arch_type):
    cfg = _tiny(arch_type=arch_type)
    with pytest.raises(NotImplementedError, match="no LM block"):
        blocks.check_supported(cfg)
    with pytest.raises(NotImplementedError, match="no LM block"):
        lm.init_params(cfg, torch.Generator("cpu").manual_seed(0), "cpu")


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "granite-moe-3b-a800m"])
def test_compute_params_casts_experts_keeps_qk_norm(arch):
    """The moe block's router (L, d, E) and experts (L, E, ., .) are cast
    to the activation dtype; the (L, head_dim) q/k norm scales stay f32,
    as the reference reads them at the point of use."""
    cfg = configs.get_reduced(arch)
    params = lm.init_params(cfg, torch.Generator("cpu").manual_seed(0), "cpu")
    cp = lm.compute_params(params, cfg)
    layer = cp["layers"]
    assert layer["moe"]["router"]["w"].dtype == torch.bfloat16
    for name in ("wi", "wg", "wo"):
        assert layer["moe"][name].dtype == torch.bfloat16, name
    assert ("q_norm" in layer["attn"]) == cfg.qk_norm
    for name in ("q_norm", "k_norm"):
        if cfg.qk_norm:
            scale = layer["attn"][name]["scale"]
            assert scale.dtype == torch.float32
            assert tuple(scale.shape) == (cfg.num_layers, cfg.head_dim)
    assert "mlp" not in layer and layer["ln2"]["scale"].dtype == \
        torch.float32
