"""The port's Mamba-2 mixer (``repro_torch.models.mamba``) against
``repro.models.mamba`` on the CPU, from the same numpy inputs and params:
``ssd_chunked`` (several chunks, L off the chunk, the final state),
``_causal_conv``, ``mamba_mixer`` with and without its cache,
``mamba_decode_step`` and the mixer's gradients; then the ssm and hybrid
blocks' prefill against their own decode loop (the reference's
``TestDecodeConsistency`` and ``TestPrefillEquivalence`` cases).

Tolerances: the SSD at ``tests/test_models.py``'s atol 2e-4 / rtol 1e-3;
the mixer and its decode step at ``tests/test_torch_lm.py``'s ``TOL``
(f32 1e-4 outputs, 1e-5 caches; bf16 0.05 / 0.08); gradients at
``tests/test_torch_lm_train.py``'s f32 atol 2e-5 / rtol 1e-4; prefill
against decode at ``tests/test_models.py``'s logits atol 0.15 / rtol 0.1
and ``tests/test_serve.py``'s ``CACHE_ATOL``.  Last, reduced Hymba
trained beside the reference trainer.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.core.types import ModelConfig  # noqa: E402
from repro_torch.models import lm, mamba  # noqa: E402
# the held-out trajectory helper of the MoE family's training test
from test_torch_lm_train import _held_out_trajectory  # noqa: E402

SSD_TOL = dict(atol=2e-4, rtol=1e-3)
TOL = {"float32": {"out": 1e-4, "cache": 1e-5},
       "bfloat16": {"out": 0.05, "cache": 0.08}}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CACHE_ATOL = {"k": 0.08, "v": 0.08, "conv": 0.08, "ssm": 5e-3}


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _ssd_inputs(L, b=2, H=3, P=8, N=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, L, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal((H,))).astype(np.float32)
    B = rng.standard_normal((b, L, N)).astype(np.float32)
    C = rng.standard_normal((b, L, N)).astype(np.float32)
    D = np.ones((H,), np.float32)
    return x, dt, A, B, C, D


@pytest.mark.parametrize("L,chunk", [(64, 16), (130, 32), (100, 256),
                                     (37, 8)])
def test_ssd_chunked_matches_the_recurrence_and_jax(L, chunk):
    """Several chunks, L off the chunk (the zero-dt padding); the final
    state against the reference's ``return_final_state``."""
    args = _ssd_inputs(L)
    want = jax.jit(jmamba.ssd_reference)(*args)
    jy, jstate = jax.jit(lambda *a: jmamba.ssd_chunked(
        *a, chunk=chunk, return_final_state=True))(*args)
    t = [torch.from_numpy(a) for a in args]
    y, state = mamba.ssd_chunked(*t, chunk=chunk, return_final_state=True)
    assert y.dtype == torch.float32 and state.shape == (2, 3, 8, 16)
    np.testing.assert_allclose(_f32(y), _f32(want), **SSD_TOL)
    np.testing.assert_allclose(_f32(y), _f32(jy), **SSD_TOL)
    np.testing.assert_allclose(_f32(mamba.ssd_reference(*t)), _f32(want),
                               **SSD_TOL)
    np.testing.assert_allclose(_f32(state), _f32(jstate), **SSD_TOL)
    # one chunk of the whole sequence carries the same final state
    _, whole = mamba.ssd_chunked(*t, chunk=L, return_final_state=True)
    np.testing.assert_allclose(_f32(state), _f32(whole), **SSD_TOL)


def test_ssd_chunked_grads_finite_where_the_reference_overflows():
    """A chunk whose decay sum passes 88 overflows f32's exp above the
    diagonal: the reference's ``ssd_chunked`` gradient is NaN there, the
    port's (masked before the exp) matches ``jax.grad`` of the sequential
    recurrence, and both forwards agree."""
    args = list(_ssd_inputs(48, seed=1))
    args[2] = args[2] * 0 - 8.0          # A = -8: dt x |A| sums past 88
    jargs = list(map(jnp.asarray, args))

    def jloss(fn, x, dt, B, C):
        return (fn(x, dt, jargs[2], B, C, jargs[5]) ** 2).sum()
    chunked = (lambda *a: jmamba.ssd_chunked(*a, chunk=48))
    jg_bad = jax.jit(jax.grad(lambda *a: jloss(chunked, *a),
                              argnums=(0, 1, 2, 3)))(
        jargs[0], jargs[1], jargs[3], jargs[4])
    assert any(bool(jnp.isnan(g).any()) for g in jg_bad)
    jg = jax.jit(jax.grad(lambda *a: jloss(jmamba.ssd_reference, *a),
                          argnums=(0, 1, 2, 3)))(jargs[0], jargs[1],
                                                 jargs[3], jargs[4])
    t = [torch.from_numpy(a) for a in args]
    leaves = [t[i].requires_grad_() for i in (0, 1, 3, 4)]
    y = mamba.ssd_chunked(t[0], t[1], t[2], t[3], t[4], t[5], chunk=48)
    np.testing.assert_allclose(_f32(y), _f32(jax.jit(chunked)(*jargs)),
                               **SSD_TOL)
    grads = torch.autograd.grad((y ** 2).sum(), leaves)
    for got, want in zip(grads, jg):
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-3,
                                   rtol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 40)).astype(np.float32)
    w = (rng.standard_normal((4, 40)) * 0.1).astype(np.float32)
    b = rng.standard_normal((40,)).astype(np.float32) * 0.1
    jdt, tdt = DT[dtype]
    want = jax.jit(jmamba._causal_conv)(*(jnp.asarray(a, jdt)
                                          for a in (x, w, b)))
    got = mamba._causal_conv(*(torch.from_numpy(a).to(tdt)
                               for a in (x, w, b)))
    assert got.dtype == tdt
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype]["out"])


def _mixer_setup(dtype, arch="mamba2-370m"):
    """Reduced ``arch``'s mixer params (numpy, from the reference's init)
    in both packages, with ``ssd_chunk`` 8 so that a 21-token input runs
    three chunks, the last padded."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), dtype=dtype,
                               ssd_chunk=8)
    tcfg = dataclasses.replace(configs.get_reduced(arch), dtype=dtype,
                               ssd_chunk=8)
    jp = jmamba.init_mamba(jax.random.PRNGKey(3), jcfg.d_model,
                           jcfg.ssm_heads, jcfg.ssm_head_dim, jcfg.ssm_state,
                           jcfg.conv_kernel)
    # a nonzero bias and dt_bias, so both paths of their casts are held
    rng = np.random.default_rng(4)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["conv_b"] = rng.standard_normal(tree["conv_b"].shape).astype(
        np.float32) * 0.1
    tree["dt_bias"] = rng.standard_normal(tree["dt_bias"].shape).astype(
        np.float32) * 0.5
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                tree)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [21, 2])
def test_mixer_and_its_cache_match_jax(dtype, L):
    """Without and with ``return_cache``; L = 2 < k - 1 left-pads the
    conv tail."""
    jcfg, tcfg, jp, tp = _mixer_setup(dtype)
    jdt, tdt = DT[dtype]
    x = np.random.default_rng(5).standard_normal(
        (2, L, jcfg.d_model)).astype(np.float32)
    want, (jout, jcache) = jax.jit(lambda p, x: (
        jmamba.mamba_mixer(p, x, jcfg),
        jmamba.mamba_mixer(p, x, jcfg, return_cache=True,
                           cache_dtype=jdt)))(jp, jnp.asarray(x, jdt))
    with torch.no_grad():
        got = mamba.mamba_mixer(tp, torch.from_numpy(x).to(tdt), tcfg)
        out, cache = mamba.mamba_mixer(tp, torch.from_numpy(x).to(tdt), tcfg,
                                       return_cache=True, cache_dtype=tdt)
    assert got.dtype == tdt and torch.equal(got, out)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype]["out"])
    np.testing.assert_allclose(_f32(out), _f32(jout), atol=TOL[dtype]["out"])
    assert cache["ssm"].dtype == torch.float32 and cache["conv"].dtype == tdt
    for leaf in ("ssm", "conv"):
        assert tuple(cache[leaf].shape) == jcache[leaf].shape
        np.testing.assert_allclose(_f32(cache[leaf]), _f32(jcache[leaf]),
                                   atol=TOL[dtype]["cache"], err_msg=leaf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax_in_place(dtype):
    """Three decode steps from a prefill cache, each against the
    reference's; the port writes the cache it was given."""
    jcfg, tcfg, jp, tp = _mixer_setup(dtype)
    jdt, tdt = DT[dtype]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    _, jc = jax.jit(lambda p, x: jmamba.mamba_mixer(
        p, x, jcfg, return_cache=True, cache_dtype=jdt))(jp,
                                                         jnp.asarray(x, jdt))
    jstep = jax.jit(lambda p, x, c: jmamba.mamba_decode_step(p, x, c, jcfg))
    with torch.no_grad():
        _, tc = mamba.mamba_mixer(tp, torch.from_numpy(x).to(tdt), tcfg,
                                  return_cache=True, cache_dtype=tdt)
        held = {k: v for k, v in tc.items()}
        for _ in range(3):
            step = rng.standard_normal((2, 1, jcfg.d_model)).astype(
                np.float32)
            jout, jc = jstep(jp, jnp.asarray(step, jdt), jc)
            out, same = mamba.mamba_decode_step(
                tp, torch.from_numpy(step).to(tdt), tc, tcfg)
            assert same is tc and all(tc[k] is held[k] for k in tc)
            assert out.dtype == tdt and tuple(out.shape) == jout.shape
            np.testing.assert_allclose(_f32(out), _f32(jout),
                                       atol=TOL[dtype]["out"])
    for leaf in ("ssm", "conv"):
        np.testing.assert_allclose(_f32(tc[leaf]), _f32(jc[leaf]),
                                   atol=TOL[dtype]["cache"], err_msg=leaf)


def test_mixer_grads_match_jax_grad():
    """Every parameter's and the input's gradient, f32, three chunks."""
    jcfg, tcfg, jp, tp = _mixer_setup("float32")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 21, jcfg.d_model)).astype(np.float32)
    g = rng.standard_normal((2, 21, jcfg.d_model)).astype(np.float32)

    def jloss(p, x):
        return (jmamba.mamba_mixer(p, x, jcfg) * g).sum()
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    xt = torch.from_numpy(x).requires_grad_()
    out = mamba.mamba_mixer(tree_unflatten(tp, leaves), xt, tcfg)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                leaves + [xt])
    want = jax.tree_util.tree_leaves(jgp) + [jgx]
    assert len(grads) == len(want)
    for got, w in zip(grads, want):
        np.testing.assert_allclose(_f32(got), _f32(w), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_compute_params_keeps_the_mixer_vectors(arch):
    """The serving copy casts the projections to bf16 and keeps A_log, D,
    dt_bias, conv_b, norm_scale (stacked (L, .)), the hybrid's betas and
    norms, and the conv filter in f32."""
    cfg = configs.get_reduced(arch)
    params = lm.init_params(cfg, torch.Generator("cpu").manual_seed(0), "cpu")
    layer = lm.compute_params(params, cfg)["layers"]
    mix = layer["mamba"]
    for name in ("in_proj", "out_proj"):
        assert mix[name]["w"].dtype == torch.bfloat16, name
    for name in ("A_log", "D", "dt_bias", "conv_b", "norm_scale", "conv_w"):
        assert mix[name].dtype == torch.float32, name
        assert mix[name].shape[0] == cfg.num_layers
    assert ("attn" in layer) == (cfg.arch_type == "hybrid")
    if cfg.arch_type == "hybrid":
        for name in ("beta_attn", "beta_ssm"):
            assert layer[name].dtype == torch.float32
        for name in ("bn_attn", "bn_ssm", "ln2"):
            assert layer[name]["scale"].dtype == torch.float32
        assert layer["mlp"]["wo"]["w"].dtype == torch.bfloat16
    else:
        assert "ln2" not in layer and "mlp" not in layer


# ----------------------------------------------------------------------
# The blocks: prefill against the port's own decode loop
# ----------------------------------------------------------------------
def _tiny(arch_type, **kw):
    base = dict(name="t", arch_type=arch_type, num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                vocab_size=128)
    base.update(kw)
    return ModelConfig(**base)


DECODE_CFGS = {
    "ssm": _tiny("ssm", num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0,
                 ssm_heads=4, ssm_head_dim=16, ssm_state=8),
    "hybrid": _tiny("hybrid", ssm_heads=4, ssm_head_dim=16, ssm_state=8),
}


@pytest.mark.parametrize("arch", list(DECODE_CFGS))
def test_decode_loop_matches_forward_and_prefill(arch):
    """The bf16 model: 12 decode steps from an empty cache give the
    teacher-forced forward's last logits (the reference's
    ``TestDecodeConsistency``), and ``prefill``'s logits and every cache
    leaf (``TestPrefillEquivalence``)."""
    cfg = DECODE_CFGS[arch]
    params = lm.init_params(cfg, torch.Generator("cpu").manual_seed(0), "cpu")
    S = 12
    toks = torch.randint(0, cfg.vocab_size, (2, S),
                         generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        hidden, _, _ = lm.forward(params, toks, cfg)
        table = params["embed"]["table"]
        want = (hidden[:, -1] @ table.to(hidden.dtype).T).float()
        pre_logits, sl = lm.prefill(params, toks, cfg)
        cache = lm.init_cache(2, S + 1, cfg, device="cpu")
        for i in range(S):
            logits, cache = lm.decode_step(params, cache, i,
                                           toks[:, i:i + 1], cfg)
    np.testing.assert_allclose(_f32(logits[:, 0]), _f32(want), atol=0.15,
                               rtol=0.1)
    np.testing.assert_allclose(_f32(pre_logits), _f32(logits), atol=0.05)

    def check(a, b, name=""):
        if isinstance(a, dict):
            for k in a:
                check(a[k], b[k], k)
            return
        if a.shape != b.shape:               # kv: the slice holds P
            b = b[:, :, :a.shape[2]]
        np.testing.assert_allclose(_f32(a), _f32(b), atol=CACHE_ATOL[name],
                                   err_msg=name)
    assert set(sl.layers) == set(cache.layers) == (
        {"mamba"} if arch == "ssm" else {"kv", "mamba"})
    check(sl.layers, cache.layers)


HYMBA_CHUNK, HYMBA_STEPS = 4, 10


def test_hymba_held_out_trajectory_matches_the_reference():
    """Reduced Hymba in f32 trained as ``chip_smoke.py``'s phase 4k trains
    it at full width (``test_torch_lm_train._held_out_trajectory``) over
    HYMBA_STEPS steps: the held-out objective and CE after every step
    agree with the reference's within rtol 1e-4 / atol 1e-6, and both
    fall.  The SSD runs in chunks of HYMBA_CHUNK tokens: at its default
    chunk the reference's gradients are NaN at this length (a chunk's
    decay overflows f32's exp above the diagonal; the port masks before
    the exp), so there is no reference trajectory to hold the port to;
    at 4 tokens the decay stays in range and the SSD's chunks, padding
    and chained states all run."""
    trace = _held_out_trajectory("hymba-1.5b", HYMBA_STEPS,
                                 ssd_chunk=HYMBA_CHUNK)
    for i, (want, got) in enumerate(trace):
        assert np.isfinite(want).all()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                   err_msg=f"after step {i}")
    (o0, c0, _), (o1, c1, _) = trace[0][1], trace[-1][1]
    assert o1 < o0 and c1 < c0
