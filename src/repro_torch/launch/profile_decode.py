"""Where a decode step's time goes on the card, by kernel.

Builds full-width ``--arch`` (default Yi-6B) from a seed on the card,
fills every slot with a prompt, times ``--steps`` decode steps without the
profiler (each one synchronised: the median and fastest step), then
traces ``--steps`` more with ``torch.profiler`` and prints the device time
by kernel name, the traced steps' wall time and the card's busy share over
the traced window:

    python -m repro_torch.launch.profile_decode --steps 5
    python -m repro_torch.launch.profile_decode --arch gemma2-27b --layers 8

``--layers`` cuts the depth (full width kept), for a model whose full
depth does not fit the card with its f32 masters and bf16 copy.

Needs one NVIDIA card; prints the card's name and power limit beside the
numbers.  ``--json PATH`` also writes them as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.device import resolve_device
from repro_torch.models import lm
from repro_torch.serving import ServeConfig, make_serve_engine


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def annotation(evt) -> bool:
    """A span (a schedule's ``ProfilerStep``, a ``record_function``), not
    a kernel: an event of ``prof.events()`` or of ``key_averages()``."""
    return evt.key.startswith("ProfilerStep") or bool(
        getattr(evt, "is_user_annotation", False))


def busy_us(prof) -> float:
    """Union of the device kernel intervals, in microseconds.  A
    profiler schedule's ``ProfilerStep`` span, and each
    ``record_function`` span (the moe layer's), also lands on the
    device's timeline, from its first kernel to its last; it is no
    work."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not annotation(e))
    busy, end = 0.0, -1.0
    for s, e in spans:
        if s >= end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b", choices=configs.ARCH_NAMES)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0,
                    help="depth to build (0: the config's own)")
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    cfg = configs.get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(args.seed),
                            device=dev)
    eng = make_serve_engine(params, cfg, ServeConfig(
        slots=args.slots, max_seq=args.prompt + 2 * args.steps + 8),
        device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.slots, args.prompt))
    _, sl, _ = eng.prefill(prompts)
    for slot in range(args.slots):
        eng.insert(sl, slot, row=slot)
    toks = rng.integers(0, cfg.vocab_size, (args.slots,))
    for _ in range(2):                       # warm-up
        eng.decode(toks)
    torch.cuda.synchronize()
    plain_ms = []                            # the profiler adds host time
    for _ in range(args.steps):
        t0 = time.perf_counter()
        eng.decode(toks)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.decode(toks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(evt.key, device_us(evt) / 1e3 / args.steps, evt.count
             // args.steps) for evt in prof.key_averages()
            if device_us(evt) > 0 and evt.device_type
            == torch.autograd.DeviceType.CUDA and not annotation(evt)]
    rows.sort(key=lambda r: -r[1])
    step_ms = wall_ms / args.steps
    busy_ms = busy_us(prof) / 1e3 / args.steps
    card = _card()
    print(f"[profile] {cfg.name} full width, {cfg.num_layers} layers, "
          f"{args.slots} slots, "
          f"{args.steps} decode steps on {card}")
    print(f"[profile] unprofiled step median {np.median(plain_ms):.3f} ms, "
          f"fastest {min(plain_ms):.3f} ms")
    print(f"[profile] step {step_ms:.3f} ms wall, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / step_ms:.1f}%)"
          if rows else "[profile] device time: not measured")
    for key, ms, n in rows[:15]:
        print(f"[profile] {ms:9.4f} ms/step {n:6d} launches/step  {key[:90]}")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"card": card, "arch": cfg.name,
                       "layers": cfg.num_layers, "slots": args.slots,
                       "steps": args.steps, "step_ms": step_ms,
                       "unprofiled_step_ms": plain_ms,
                       "busy_ms": busy_ms, "kernels": [
                           {"name": k, "ms_per_step": ms,
                            "launches_per_step": n} for k, ms, n in rows]},
                      fh, indent=1)


if __name__ == "__main__":
    main()
