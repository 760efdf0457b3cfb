"""The port's serving path against the JAX engines: the same params and
request stream through ``repro.serving`` and ``repro_torch.serving``
under the deterministic cost clock give the same event streams, on reduced
Yi-6B, on reduced Gemma-2 with prompts longer than its window, and on the
reduced MoE family (Qwen3-MoE with ``qk_norm``, Granite-MoE), on
reduced Mamba2 and on reduced Hymba with prompts longer than its window;
plus the slot invariants, the explicit device contract and a CLI smoke."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs, serving  # noqa: E402
from repro_torch.core.types import ModelConfig  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

SERVE = dict(slots=3, max_seq=64, timing="model", cache_dtype="float32",
             slot_cost_ms=0.5)


def _f32_pair(arch):
    """Reduced ``arch`` in f32: (jax cfg, jax params, port cfg, port
    params) from one numpy tree."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), dtype="float32")
    tcfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32")
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def f32_pair():
    """Reduced Yi-6B in f32."""
    return _f32_pair("yi-6b")


@pytest.fixture(scope="module")
def gemma_pair():
    """Reduced Gemma-2 in f32 (window 16 on layer 0, global layer 1)."""
    return _f32_pair("gemma2-27b")


def _events(evs):
    return [(e.kind, e.request, e.slot, e.token, round(e.t_ms, 6),
             None if e.tokens is None else list(map(int, e.tokens)))
            for e in evs]


@pytest.mark.parametrize("batching", ["continuous", "static"])
def test_event_streams_match_jax(f32_pair, batching):
    jcfg, jp, tcfg, tp = f32_pair
    reqs = serving.poisson_requests(7, rate_rps=400.0, seed=3,
                                    gen_lens=(2, 4, 9, 12),
                                    vocab_size=tcfg.vocab_size)
    jeng = jserving.make_serve_engine(jp, jcfg, jserving.ServeConfig(
        batching=batching, **SERVE))
    teng = serving.make_serve_engine(tp, tcfg, serving.ServeConfig(
        batching=batching, **SERVE), device="cpu")
    assert type(teng).__name__ == type(jeng).__name__
    want = _events(jeng.run(reqs))
    got = _events(teng.run(reqs))
    assert sum(k == "complete" for k, *_ in got) == 7
    assert got == want


@pytest.mark.parametrize("batching", ["continuous", "static"])
def test_gemma2_event_streams_match_jax(gemma_pair, batching):
    """Prompts of 20-36 tokens against a window of 16: the local layer
    masks in prefill and in every decode step."""
    jcfg, jp, tcfg, tp = gemma_pair
    reqs = serving.poisson_requests(6, rate_rps=400.0, seed=4,
                                    prompt_lens=(20, 28, 36),
                                    gen_lens=(2, 4, 9, 12),
                                    vocab_size=tcfg.vocab_size)
    jeng = jserving.make_serve_engine(jp, jcfg, jserving.ServeConfig(
        batching=batching, **SERVE))
    teng = serving.make_serve_engine(tp, tcfg, serving.ServeConfig(
        batching=batching, **SERVE), device="cpu")
    want = _events(jeng.run(reqs))
    got = _events(teng.run(reqs))
    assert sum(k == "complete" for k, *_ in got) == 6
    assert got == want


ARCHS = ("qwen3-moe-30b-a3b", "granite-moe-3b-a800m")


@pytest.fixture(scope="module", params=ARCHS)
def moe_pair(request):
    """A reduced MoE config in f32."""
    return _f32_pair(request.param)


@pytest.mark.parametrize("batching", ["continuous", "static"])
def test_moe_event_streams_match_jax(moe_pair, batching):
    """Each decode step routes every slot's token, free slots included;
    the per-row dispatch keeps a slot's routing its own."""
    jcfg, jp, tcfg, tp = moe_pair
    reqs = serving.poisson_requests(6, rate_rps=400.0, seed=5,
                                    gen_lens=(2, 4, 9, 12),
                                    vocab_size=tcfg.vocab_size)
    jeng = jserving.make_serve_engine(jp, jcfg, jserving.ServeConfig(
        batching=batching, **SERVE))
    teng = serving.make_serve_engine(tp, tcfg, serving.ServeConfig(
        batching=batching, **SERVE), device="cpu")
    want = _events(jeng.run(reqs))
    got = _events(teng.run(reqs))
    assert sum(k == "complete" for k, *_ in got) == 6
    assert got == want


SSM_ARCHS = ("mamba2-370m", "hymba-1.5b")


@pytest.fixture(scope="module", params=SSM_ARCHS)
def ssm_pair(request):
    """A reduced ssm or hybrid config in f32."""
    return _f32_pair(request.param)


@pytest.mark.parametrize("batching", ["continuous", "static"])
def test_ssm_event_streams_match_jax(ssm_pair, batching):
    """Each decode step advances every slot's state, free slots included,
    and an insert overwrites a slot's state whole; prompts of 20-36
    tokens pass Hymba's window of 16."""
    jcfg, jp, tcfg, tp = ssm_pair
    reqs = serving.poisson_requests(6, rate_rps=400.0, seed=7,
                                    prompt_lens=(20, 28, 36),
                                    gen_lens=(2, 4, 9, 12),
                                    vocab_size=tcfg.vocab_size)
    jeng = jserving.make_serve_engine(jp, jcfg, jserving.ServeConfig(
        batching=batching, **SERVE))
    teng = serving.make_serve_engine(tp, tcfg, serving.ServeConfig(
        batching=batching, **SERVE), device="cpu")
    want = _events(jeng.run(reqs))
    got = _events(teng.run(reqs))
    assert sum(k == "complete" for k, *_ in got) == 6
    assert got == want


def test_gemma2_generate_matches_jax(gemma_pair):
    jcfg, jp, tcfg, tp = gemma_pair
    prompts = np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (2, 24)).astype(np.int32)
    want = jserving.make_serve_engine(jp, jcfg, jserving.ServeConfig(
        **SERVE)).generate(prompts, 8)
    got = serving.make_serve_engine(tp, tcfg, serving.ServeConfig(
        **SERVE), device="cpu").generate(prompts, 8)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_scheduler_stream_matches_jax():
    a = serving.poisson_requests(9, rate_rps=50.0, seed=11, vocab_size=300)
    b = jserving.poisson_requests(9, rate_rps=50.0, seed=11, vocab_size=300)
    assert [(r.id, r.arrival_ms, r.max_new_tokens) for r in a] == \
        [(r.id, r.arrival_ms, r.max_new_tokens) for r in b]
    assert all(np.array_equal(x.tokens, y.tokens) for x, y in zip(a, b))


class TestSlotInvariants:
    def test_insert_evict_lengths(self, f32_pair):
        _, _, cfg, params = f32_pair
        cache = lm.init_cache(4, 32, cfg, device="cpu")
        with torch.inference_mode():
            _, sl = lm.prefill(params, torch.zeros((1, 5), dtype=torch.int32),
                               cfg)
        cache = lm.cache_insert(cache, sl, 2)
        assert cache.lengths.tolist() == [0, 0, 5, 0]
        assert torch.equal(cache.layers["kv"]["k"][:, 2, :5],
                           sl.layers["kv"]["k"][:, 0])
        cache = lm.cache_evict(cache, 2)
        assert cache.lengths.tolist() == [0, 0, 0, 0]

    def test_auto_increment_only_occupied(self, f32_pair):
        _, _, cfg, params = f32_pair
        cache = lm.init_cache(4, 32, cfg, device="cpu")
        with torch.inference_mode():
            _, sl = lm.prefill(params, torch.zeros((1, 5), dtype=torch.int32),
                               cfg)
            cache = lm.cache_insert(cache, sl, 1)
            _, cache = lm.decode_step(params, cache, None,
                                      torch.zeros((4, 1), dtype=torch.int32),
                                      cfg)
        assert cache.lengths.tolist() == [0, 6, 0, 0]

    def test_full_row_writes_nothing(self, f32_pair):
        """A row whose length reached max_seq leaves its cache as it was."""
        _, _, cfg, params = f32_pair
        cache = lm.init_cache(2, 6, cfg, dtype=torch.float32, device="cpu")
        with torch.inference_mode():
            _, sl = lm.prefill(params, torch.ones((1, 6), dtype=torch.int32),
                               cfg, cache_dtype=torch.float32)
            cache = lm.cache_insert(cache, sl, 0)
            before = cache.layers["kv"]["k"][:, 0].clone()
            lm.decode_step(params, cache, None,
                           torch.zeros((2, 1), dtype=torch.int32), cfg)
        assert torch.equal(cache.layers["kv"]["k"][:, 0], before)

    def test_evicted_slots_are_reused(self, f32_pair):
        _, _, cfg, params = f32_pair
        eng = serving.make_serve_engine(params, cfg, serving.ServeConfig(
            slots=2, max_seq=48, timing="model"), device="cpu")
        reqs = serving.poisson_requests(6, rate_rps=1e4, seed=0,
                                        gen_lens=(2, 4, 8, 16),
                                        vocab_size=cfg.vocab_size)
        evs = list(eng.run(reqs))
        used = [e.slot for e in evs if e.kind == "prefill"]
        assert set(used) == {0, 1} and len(used) == 6
        assert sum(e.kind == "complete" for e in evs) == 6
        assert eng.cache.lengths.tolist() == [0, 0]
        assert eng.prefill_calls == 6 and eng.decode_calls > 0


def test_generate_matches_jax(f32_pair):
    jcfg, jp, tcfg, tp = f32_pair
    prompts = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, 6)).astype(np.int32)
    want = jserving.make_serve_engine(jp, jcfg, jserving.ServeConfig(
        **SERVE)).generate(prompts, 5)
    got = serving.make_serve_engine(tp, tcfg, serving.ServeConfig(
        **SERVE), device="cpu").generate(prompts, 5)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_encdec_rejected():
    cfg = ModelConfig(name="t", arch_type="encdec", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                      num_encoder_layers=2)
    with pytest.raises(ValueError, match="encdec"):
        serving.resolve_serve_engine(cfg)


def test_unported_arch_rejected(f32_pair):
    """An arch type with no LM block (the CNN's), not vlm or hybrid, since
    every block of the reference's dispatch is ported."""
    _, _, cfg, params = f32_pair
    cnn = dataclasses.replace(cfg, arch_type="cnn")
    with pytest.raises(NotImplementedError, match="cnn"):
        serving.make_serve_engine(params, cnn, device="cpu")


def test_make_serve_engine_without_device_needs_a_card(monkeypatch, f32_pair):
    _, _, cfg, params = f32_pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serving.make_serve_engine(params, cfg)


def test_params_on_another_device_rejected(f32_pair):
    _, _, cfg, params = f32_pair
    meta = lm.init_params(cfg, None, device="meta")
    with pytest.raises(ValueError, match="meta"):
        serving.make_serve_engine(meta, cfg, device="cpu")


def test_cli_smoke_cpu(capsys):
    lat = serve_cli.main(["--device", "cpu", "--requests", "3", "--gen", "4",
                          "--rate", "300", "--timing", "model"])
    out = capsys.readouterr().out
    assert len(lat) == 3
    assert "yi-6b continuous: 3 requests" in out


def test_cli_smoke_cpu_gemma2(capsys):
    lat = serve_cli.main(["--arch", "gemma2-27b", "--device", "cpu",
                          "--requests", "3", "--gen", "4", "--rate", "300",
                          "--timing", "model"])
    out = capsys.readouterr().out
    assert len(lat) == 3
    assert "gemma2-27b continuous: 3 requests" in out


def test_cli_smoke_cpu_qwen3_moe(capsys):
    lat = serve_cli.main(["--arch", "qwen3-moe-30b-a3b", "--device", "cpu",
                          "--requests", "3", "--gen", "4", "--rate", "300",
                          "--timing", "model"])
    out = capsys.readouterr().out
    assert len(lat) == 3
    assert "qwen3-moe-30b-a3b continuous: 3 requests" in out


def test_cli_smoke_cpu_mamba2(capsys):
    lat = serve_cli.main(["--arch", "mamba2-370m", "--device", "cpu",
                          "--requests", "3", "--gen", "4", "--rate", "300",
                          "--timing", "model"])
    out = capsys.readouterr().out
    assert len(lat) == 3
    assert "mamba2-370m continuous: 3 requests" in out


def test_cli_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve_cli.main(["--requests", "1"])
