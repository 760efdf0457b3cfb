"""The port's MoE layer (``repro_torch.models.moe``) against
``repro.models.moe`` on the CPU: the same numpy params and inputs through
both ``moe_layer``s, in f32, at capacity factors 8.0 (dropless), 1.25
(the configs' default) and 0.5 (copies dropped).

The routing must be the reference's exactly: ``top_e`` as the
reference's own ``jax.lax.top_k`` call returns it (captured from inside
its ``moe_layer``), and ``keep`` and the slots as the reference's
dispatch (``moe.py:69-80``, here in numpy) derives them from it.  The
output is held at atol 1e-5 / rtol 1e-5 (f32 sums in another order) and
the aux at rtol 1e-6.  Then the tie rule (``jax.lax.top_k`` gives the
lower expert first on equal probabilities; ``torch.topk`` does not), the
per-row dispatch (a row's output does not depend on another row), and
the gradients of the output and aux to x, the router and the experts
against ``jax.grad``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.core.types import ModelConfig  # noqa: E402
from repro_torch.models import moe  # noqa: E402

B, S = 3, 16
FACTORS = (8.0, 1.25, 0.5)


def _cfg(E=8, k=3, d=32, f=16, activation="silu"):
    return ModelConfig(name="moe-test", arch_type="moe", num_layers=1,
                       d_model=d, num_heads=4, num_kv_heads=2, head_dim=8,
                       d_ff=0, num_experts=E, top_k=k, expert_d_ff=f,
                       activation=activation)


def _inputs(cfg, seed=0, tie_columns=False):
    """numpy (params, x): x (B, S, d); the router's w scaled so the
    probabilities spread.  ``tie_columns`` copies expert 0's router column
    to experts 2 and 5, so those three always tie."""
    rng = np.random.default_rng(seed)
    E, d, f = cfg.num_experts, cfg.d_model, cfg.expert_d_ff
    w = (rng.standard_normal((d, E)) * 2.0 / np.sqrt(d)).astype(np.float32)
    if tie_columns:
        w[:, 2] = w[:, 0]
        w[:, 5] = w[:, 0]
    def normal(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)
    params = {"router": {"w": w}, "wi": normal((E, d, f), d),
              "wg": normal((E, d, f), d), "wo": normal((E, f, d), f)}
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    return params, x


def _jax(params, x):
    return jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x)


def _torch(params, x, requires_grad=False):
    tp = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(requires_grad),
        params)
    return tp, torch.from_numpy(x.copy()).requires_grad_(requires_grad)


def _reference(params, x, cfg, cf, monkeypatch):
    """The reference's (out, aux) and the ``top_e`` its own top_k call
    returned."""
    seen = []
    top_k = jax.lax.top_k

    def recording(operand, k):
        out = top_k(operand, k)
        seen.append(np.asarray(out[1]))
        return out
    monkeypatch.setattr(jax.lax, "top_k", recording)
    jp, jx = _jax(params, x)
    out, aux = jmoe.moe_layer(jp, jx, cfg, capacity_factor=cf)
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    assert len(seen) == 1
    return np.asarray(out), float(aux), seen[0]


def _dispatch(top_e, E, C):
    """``moe.py:69-80`` in numpy: per row, the stable sort of the flat
    expert ids, each copy's rank in its expert, keep and slot."""
    Bn, Sn, k = top_e.shape
    T = Sn * k
    flat = top_e.reshape(Bn, T)
    order = np.argsort(flat, axis=-1, kind="stable")
    sorted_e = np.take_along_axis(flat, order, axis=-1)
    counts = np.stack([np.bincount(r, minlength=E) for r in flat])
    starts = np.cumsum(counts, axis=-1) - counts
    ranks = np.arange(T)[None] - np.take_along_axis(starts, sorted_e, -1)
    keep = ranks < C
    return keep, np.where(keep, sorted_e * C + ranks, E * C)


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("tie", [False, True], ids=["spread", "ties"])
def test_moe_layer_matches_jax(cf, tie, monkeypatch):
    cfg = _cfg()
    params, x = _inputs(cfg, tie_columns=tie)
    jout, jaux, jtop_e = _reference(params, x, cfg, cf, monkeypatch)
    tp, tx = _torch(params, x)
    with torch.no_grad():
        r = moe.route(tp, tx, cfg, capacity_factor=cf)
        out, aux = moe.moe_layer(tp, tx, cfg, capacity_factor=cf)
    C = moe.capacity(S, cfg.top_k, cf, cfg.num_experts)
    assert r["C"] == C == max(1, int(S * cfg.top_k * cf / cfg.num_experts))
    np.testing.assert_array_equal(r["top_e"].numpy(), jtop_e)
    keep, slot = _dispatch(jtop_e, cfg.num_experts, C)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    np.testing.assert_array_equal(r["slot"].numpy(), slot)
    if cf == 8.0:
        assert keep.all()
    if cf == 0.5:
        assert not keep.all()
    assert out.dtype == torch.float32 and tuple(out.shape) == jout.shape
    np.testing.assert_allclose(out.numpy(), jout, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux), jaux, rtol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_tie_rule_matches_jax_top_k(k):
    """Probabilities drawn from five values, so most rows tie at the
    k-th place: the same experts, in the same order, as
    ``jax.lax.top_k``."""
    rng = np.random.default_rng(k)
    probs = rng.choice(np.array([0.05, 0.1, 0.2, 0.3, 0.35], np.float32),
                       (64, 8))
    desc = np.sort(probs, -1)[:, ::-1]
    assert (desc[:, k - 1] == desc[:, k]).mean() > 0.2
    jv, je = jax.lax.top_k(jnp.asarray(probs), k)
    tv, te = moe.top_k(torch.from_numpy(probs), k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_top_k_example_from_the_reference_tie_rule():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3]])
    assert moe.top_k(probs, 2)[1].tolist() == [[1, 2]]
    want = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)[1]
    assert np.asarray(want).tolist() == [[1, 2]]


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_dispatch_is_per_row(cf):
    """Changing row 1's tokens leaves rows 0 and 2 bit for bit: no row
    takes another's capacity."""
    cfg = _cfg()
    params, x = _inputs(cfg)
    y = x.copy()
    y[1] = np.random.default_rng(9).standard_normal(y[1].shape) * 3.0
    tp, tx = _torch(params, x)
    _, ty = _torch(params, y)
    with torch.no_grad():
        a, _ = moe.moe_layer(tp, tx, cfg, capacity_factor=cf)
        b, _ = moe.moe_layer(tp, ty, cfg, capacity_factor=cf)
    assert torch.equal(a[[0, 2]], b[[0, 2]])
    assert not torch.equal(a[1], b[1])


def test_load_balance_loss_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 7, 6)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    mask = (rng.random((2, 7, 6)) < 0.3).astype(np.float32)
    want = float(jmoe.load_balance_loss(jnp.asarray(probs),
                                        jnp.asarray(mask)))
    got = float(moe.load_balance_loss(torch.from_numpy(probs),
                                      torch.from_numpy(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_gradients_match_jax_grad(cf, activation):
    """d(sum(out * g) + 0.01 aux) to x, the router and wi/wg/wo, at the
    f32 gradient tolerance (atol 2e-5 / rtol 1e-4)."""
    cfg = _cfg(activation=activation)
    params, x = _inputs(cfg, seed=2)
    g = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.moe_layer(p, x, cfg, capacity_factor=cf)
        return jnp.sum(out * jnp.asarray(g)) + 0.01 * aux
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(*_jax(params, x))
    tp, tx = _torch(params, x, requires_grad=True)
    out, aux = moe.moe_layer(tp, tx, cfg, capacity_factor=cf)
    loss = (out * torch.from_numpy(g)).sum() + 0.01 * aux
    leaves = [tp["router"]["w"], tp["wi"], tp["wg"], tp["wo"], tx]
    got = torch.autograd.grad(loss, leaves)
    want = [jgp["router"]["w"], jgp["wi"], jgp["wg"], jgp["wo"], jgx]
    for name, a, b in zip(("router", "wi", "wg", "wo", "x"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=1e-4, err_msg=name)
    assert float(got[0].abs().sum()) > 0


def test_bf16_layer_keeps_dtype_and_reruns_bit_for_bit():
    """In bf16 the output stays bf16 and the aux f32; a second call gives
    the same bits (no atomics in the combine)."""
    cfg = _cfg()
    params, x = _inputs(cfg, seed=3)
    tp, tx = _torch(params, x)
    tp = jax.tree_util.tree_map(lambda t: t.bfloat16(), tp)
    with torch.no_grad():
        a, aux = moe.moe_layer(tp, tx.bfloat16(), cfg)
        b, _ = moe.moe_layer(tp, tx.bfloat16(), cfg)
    assert a.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert torch.equal(a, b)


def test_init_moe_layout_matches_jax():
    cfg = dataclasses.replace(_cfg(), num_layers=3)
    want = jax.eval_shape(lambda k: jmoe.init_moe(
        k, cfg.d_model, cfg.num_experts, cfg.expert_d_ff),
        jax.random.PRNGKey(0))
    got = moe.init_moe(torch.Generator().manual_seed(0), cfg.d_model,
                       cfg.num_experts, cfg.expert_d_ff, stack=(3,))
    flat = jax.tree_util.tree_map(lambda s: (3, *s.shape), want)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == flat


def test_profile_reads_the_spans_as_annotations_not_kernels():
    """The layer's ``record_function`` spans are annotations, in the
    trace's events and in its averages alike: ``profile_decode`` leaves
    them out of kernel and busy time; the ops under them are not."""
    from repro_torch.launch.profile_decode import annotation
    cfg = _cfg()
    params, x = _inputs(cfg)
    tp, tx = _torch(params, x)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        moe.moe_layer(tp, tx, cfg)
    for events in (prof.events(), prof.key_averages()):
        spans = {e.key for e in events if annotation(e)}
        assert set(moe.SPANS) <= spans
        assert not any(annotation(e) for e in events
                       if e.key.startswith("aten::"))
