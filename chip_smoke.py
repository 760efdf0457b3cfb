#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

from the root of a checkout.  Phases, each of which raises on failure
(the script then exits non-zero and prints no result):

1. the card's name and power limit; build every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in
   parallel) and print the compiler's register/spill report;
2. K1 (``dense_fwd``) against its plain version ``dense_ref`` on the card
   at every Yi-6B projection shape at M = 4 and 24 in bf16, plus ragged
   cases; kernel, plain and ``torch.matmul`` times by CUDA events, beside
   the least time the card could take;
3. reduced Yi-6B in f32 served on the card and on the CPU from the same
   weights and request stream: identical token streams, logits within
   1e-4;
4. the slice: full-width Yi-6B from a seed, 8 Poisson requests through the
   continuous-batching engine with measured timing; every request
   completes, logits are finite and K1 ran 224 times per forward call;
5. the serving CLI once on the reduced config;
6. a JSON line with every ported kernel, then the card again, then the
   result line ``{"ok": true, "device": {...}}``.

It needs one card, imports no JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
BF16_TOL = 1e-2                    # x max|ref|: one bf16 rounding of the output
F32_TOL = 1e-5                     # x max|ref|: f32 sums in another order
SERVE_TOL = 1e-4                   # card vs CPU logits, reduced f32 model
LAYER_SHAPES = (                   # one Yi-6B layer's projections: (name, K, N)
    ("wq", 4096, 4096), ("wk", 4096, 512), ("wv", 4096, 512),
    ("wo", 4096, 4096), ("wg", 4096, 11008), ("wi", 4096, 11008),
    ("mlp_wo", 11008, 4096))


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(M, N, K, dtype) -> tuple[float, str]:
    """Least time for act(x @ w): each input read once, the output written
    once, or the flops at the tensor cores' (bf16) or FMA (f32) peak."""
    itemsize = 2 if dtype == "bfloat16" else 4
    nbytes = (M * K + K * N + M * N) * itemsize
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * M * N * K / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, arg_sets, iters=50, warmup=5) -> float:
    """Mean time of ``fn`` by CUDA events, cycling through ``arg_sets`` so
    weights larger in total than the 50 MB L2 arrive cold, as in serving."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# ----------------------------------------------------------------------
def phase_kernel(torch, dense_mod, ref):
    """K1 against dense_ref at the serving shapes; returns the JSON row
    parts for one decode step (224 launches at M = 4)."""
    gen = torch.Generator("cuda").manual_seed(1)
    dense_cuda = dense_mod.dense_cuda
    step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
            "bound_by": set()}
    worst = {"err": 0.0, "ratio": 0.0, "tol": 0.0}
    log(f"[k1] {'shape':<19} {'M':>3}  {'max_abs_err':<12} {'tol':<10} "
        f"{'kernel_ms':<10} {'plain_ms':<10} {'library_ms':<10} "
        f"{'bound_ms':<10} bound/kernel")
    for M in (4, 24):
        for name, K, N in LAYER_SHAPES:
            wbytes = K * N * 2
            copies = max(2, min(64, math.ceil(256e6 / wbytes)))
            x = torch.randn((M, K), generator=gen, device="cuda"
                            ).to(torch.bfloat16)
            ws = [(torch.randn((K, N), generator=gen, device="cuda")
                   / math.sqrt(K)).to(torch.bfloat16) for _ in range(copies)]
            got = dense_cuda(x, ws[0])
            want = ref.dense_ref(x, ws[0])
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = BF16_TOL * want.float().abs().max().item()
            if not err <= tol:
                raise AssertionError(f"K1 {name} M={M}: max_abs_err {err} "
                                     f"> tol {tol}")
            sets = [(x, w) for w in ws]
            k_ms = time_ms(torch, dense_cuda, sets)
            p_ms = time_ms(torch, ref.dense_ref, sets)
            l_ms = time_ms(torch, torch.matmul, sets)
            b_ms, by = bound_ms(M, N, K, "bfloat16")
            log(f"[k1] {name:<7} {K:>5}x{N:<5} {M:>3}  {err:<12.4g} "
                f"{tol:<10.4g} {k_ms:<10.5f} {p_ms:<10.5f} {l_ms:<10.5f} "
                f"{b_ms:<10.5f} {b_ms / k_ms:.3f}")
            if M == 4:
                L = 32
                step["ms"] += L * k_ms
                step["plain_ms"] += L * p_ms
                step["library_ms"] += L * l_ms
                step["bound_ms"] += L * b_ms
                step["bound_by"].add(by)
                if err / tol > worst["ratio"]:
                    worst = {"err": err, "ratio": err / tol, "tol": tol}
            del x, ws, sets, got, want

    # ragged shapes: masked loads, bias and relu epilogue
    for dtype, M, K, N in (("float32", 37, 100, 77),
                           ("bfloat16", 5, 72, 70),
                           ("bfloat16", 33, 100, 130)):
        tdt = getattr(torch, dtype)
        x = torch.randn((M, K), generator=gen, device="cuda").to(tdt)
        w = torch.randn((K, N), generator=gen, device="cuda").to(tdt)
        b = torch.randn((N,), generator=gen, device="cuda")
        got = dense_cuda(x, w, b, activation="relu")
        want = ref.dense_ref(x, w, b, activation="relu")
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = (F32_TOL if dtype == "float32" else BF16_TOL) * \
            want.float().abs().max().item()
        log(f"[k1] ragged {dtype} M={M} K={K} N={N} bias+relu: "
            f"max_abs_err {err:.4g} tol {tol:.4g}")
        if not err <= tol:
            raise AssertionError(f"K1 ragged {dtype} ({M},{K},{N}): "
                                 f"max_abs_err {err} > tol {tol}")
    log(f"[k1] one decode step (224 launches, M=4): kernel "
        f"{step['ms']:.4f} ms, plain {step['plain_ms']:.4f} ms, "
        f"torch.matmul {step['library_ms']:.4f} ms, bound "
        f"{step['bound_ms']:.4f} ms ({'/'.join(sorted(step['bound_by']))})")
    return step, worst


def _logit_diff(torch, a, b):
    return (a.float().cpu() - b.float().cpu()).abs().max().item()


def phase_reduced(torch, configs, lm, serving, weights):
    """Reduced Yi-6B in f32, served on the card and on the CPU."""
    cfg = dataclasses.replace(configs.get_reduced("yi-6b"), dtype="float32")
    host = lm.init_params(cfg, torch.Generator("cpu").manual_seed(0),
                          device="cpu")
    tree = weights.params_to_numpy(host)
    params = {dev: weights.params_from_numpy(tree, cfg, dev)
              for dev in ("cuda", "cpu")}
    reqs = serving.poisson_requests(6, rate_rps=200.0, seed=0,
                                    vocab_size=cfg.vocab_size)
    sc = serving.ServeConfig(slots=4, max_seq=96, timing="model",
                             cache_dtype="float32")
    streams = {}
    for dev in ("cuda", "cpu"):
        eng = serving.make_serve_engine(params[dev], cfg, sc, device=dev)
        streams[dev] = {ev.request: ev.tokens for ev in eng.run(reqs)
                        if ev.kind == "complete"}
    if streams["cuda"] != streams["cpu"] or len(streams["cuda"]) != 6:
        raise AssertionError(f"token streams differ: card {streams['cuda']} "
                             f"cpu {streams['cpu']}")

    import numpy as np
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, (4, 3, 1)).astype(np.int32)
    out = {}
    with torch.inference_mode():
        for dev in ("cuda", "cpu"):
            logits, sl = lm.prefill(params[dev], torch.as_tensor(
                prompt, device=dev), cfg, cache_dtype=torch.float32)
            cache = lm.init_cache(3, 32, cfg, dtype=torch.float32, device=dev)
            lm.cache_insert(cache, sl, 0, 0)
            lm.cache_insert(cache, sl, 2, 1)
            seq = [logits]
            for t in steps:
                logits, cache = lm.decode_step(params[dev], cache, None,
                                               torch.as_tensor(t, device=dev),
                                               cfg)
                seq.append(logits[[0, 2]])
            out[dev] = seq
    diff = max(_logit_diff(torch, a, b) for a, b in zip(out["cuda"],
                                                        out["cpu"]))
    log(f"[reduced] yi-6b f32 card vs cpu: {len(streams['cuda'])} token "
        f"streams identical; prefill+decode logits max_abs_diff {diff:.3g} "
        f"(tol {SERVE_TOL})")
    if not diff <= SERVE_TOL:
        raise AssertionError(f"card vs cpu logits differ by {diff}")


def phase_slice(torch, configs, lm, serving, dense_mod, card):
    """Full-width Yi-6B: 8 Poisson requests, measured timing."""
    import numpy as np
    cfg = configs.get_config("yi-6b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            device="cuda")
    eng = serving.make_serve_engine(params, cfg, serving.ServeConfig(
        slots=4, max_seq=128), device="cuda")
    torch.cuda.synchronize()
    log(f"[slice] yi-6b full width ({cfg.param_count() / 1e9:.3f} B params "
        f"f32 + bf16 compute copy) ready in {time.perf_counter() - t0:.1f} s")
    eng.generate(np.zeros((1, 8), np.int32), 2)   # warm-up: CUDA/cuBLAS init

    finite, decode_ms = [], []
    prefill, decode = eng.prefill, eng.decode

    def checked_prefill(tokens):
        logits, sl, ms = prefill(tokens)
        finite.append(bool(torch.isfinite(logits).all()))
        return logits, sl, ms

    def checked_decode(tokens):
        logits, ms = decode(tokens)
        finite.append(bool(torch.isfinite(logits).all()))
        decode_ms.append(ms)
        return logits, ms

    eng.prefill, eng.decode = checked_prefill, checked_decode
    reqs = serving.poisson_requests(8, rate_rps=50, seed=0,
                                    vocab_size=cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    eng.prefill_calls = eng.decode_calls = 0
    dense_mod.dense_cuda.launches = 0
    events = list(eng.run(reqs))
    launches = dense_mod.dense_cuda.launches
    calls = eng.prefill_calls + eng.decode_calls
    peak = torch.cuda.max_memory_allocated()

    done = [ev for ev in events if ev.kind == "complete"]
    ttft = [ev.ttft_ms for ev in events if ev.kind == "prefill"]
    if len(done) != 8:
        raise AssertionError(f"{len(done)} of 8 requests completed")
    if not all(finite):
        raise AssertionError("non-finite logits in the full-width run")
    if launches != 224 * calls:
        raise AssertionError(f"K1 launches {launches} != 224 x {calls} "
                             "forward calls")
    toks = sum(len(ev.tokens) for ev in done)
    makespan = max(ev.t_ms for ev in done)
    lat = [ev.latency_ms for ev in done]
    p = np.percentile
    log(f"[slice] card: {card}")
    log(f"[slice] 8/8 requests, {toks} tokens, {eng.prefill_calls} prefill "
        f"calls + {eng.decode_calls} decode steps, K1 launches {launches} "
        f"= 224 x {calls}")
    log(f"[slice] TTFT p50 {p(ttft, 50):.3f} ms p99 {p(ttft, 99):.3f} ms | "
        f"latency p50 {p(lat, 50):.3f} ms p99 {p(lat, 99):.3f} ms | "
        f"{toks / makespan * 1e3:.2f} tok/s over {makespan:.1f} ms")
    log(f"[slice] decode step mean {np.mean(decode_ms):.3f} ms p50 "
        f"{p(decode_ms, 50):.3f} ms | max_memory_allocated "
        f"{peak / 1e9:.2f} GB ({card})")
    return launches


def phase_cli():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "yi-6b",
         "--device", "cuda", "--requests", "6", "--rate", "100",
         "--gen", "8"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"serving CLI exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    log("[cli] " + proc.stdout.strip().splitlines()[-1])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import configs, serving, weights
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import dense as dense_mod
    from repro_torch.models import lm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[card] {card}")
    t0 = time.perf_counter()
    build.build()
    log(f"[build] {list(build.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            log(f"[build] {name}: {line}")

    step, worst = phase_kernel(torch, dense_mod, ref)
    phase_reduced(torch, configs, lm, serving, weights)
    launches = phase_slice(torch, configs, lm, serving, dense_mod, card)
    phase_cli()

    row = {
        "name": "dense_fwd (K1)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dense_fwd.cu",
        "replaces": "src/repro/kernels/dense.py:46",
        "launches": launches, "max_abs_err": worst["err"],
        "tolerance": worst["tol"], "ms": step["ms"],
        "plain_ms": step["plain_ms"], "bound_ms": step["bound_ms"],
        "bound_by": "/".join(sorted(step["bound_by"])),
        "library_ms": step["library_ms"],
        "work": "one Yi-6B decode step: 224 bf16 launches at M=4",
    }
    log(json.dumps({"kernels": [row]}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
