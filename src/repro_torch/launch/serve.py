"""Serving CLI of the port: thin front-end over ``repro_torch.serving``.

Replays a Poisson request stream through the resolved serve engine on the
reduced config of ``--arch`` and prints per-request latency plus
aggregate throughput:

    python -m repro_torch.launch.serve --arch yi-6b --device cuda \
        --requests 16 --rate 50 --slots 4

``--device`` defaults to ``cuda`` and raises where no card is visible;
``--device cpu`` runs the plain PyTorch path.  Params come from
``torch.Generator(device).manual_seed(seed)``, the request stream from
numpy with the same seed.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.device import resolve_device
from repro_torch.models import lm
from repro_torch.serving import (ServeConfig, make_serve_engine,
                                 poisson_requests)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b", choices=configs.ARCH_NAMES)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=50.0,
                    help="Poisson arrival rate (requests/sec)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batching", default="continuous",
                    choices=["continuous", "static"])
    ap.add_argument("--timing", default="measured",
                    choices=["measured", "model"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_reduced(args.arch)
    gen = torch.Generator(device).manual_seed(args.seed)
    params = lm.init_params(cfg, gen, device=device)
    eng = make_serve_engine(params, cfg, ServeConfig(
        slots=args.slots, max_seq=args.max_seq, max_new_tokens=args.gen,
        batching=args.batching, timing=args.timing), device=device)
    reqs = poisson_requests(args.requests, args.rate, seed=args.seed,
                            vocab_size=cfg.vocab_size)
    print(f"[serve] {cfg.name} (reduced) on {device}")

    lat, toks, makespan = {}, 0, 0.0
    for ev in eng.run(reqs):
        if ev.kind == "prefill":
            print(f"[serve] req {ev.request:3d} slot {ev.slot} "
                  f"prefill {ev.prefill_ms:7.2f} ms  ttft {ev.ttft_ms:7.2f} ms")
        elif ev.kind == "complete":
            lat[ev.request] = ev.latency_ms
            toks += len(ev.tokens)
            print(f"[serve] req {ev.request:3d} done  t={ev.t_ms:8.1f} ms  "
                  f"latency {ev.latency_ms:7.1f} ms  "
                  f"tokens {np.asarray(ev.tokens)[:8]}...")
            makespan = ev.t_ms
    ls = np.asarray(sorted(lat.values()))
    print(f"[serve] {cfg.name} {eng.batching}: {len(lat)} requests, "
          f"{toks} tokens in {makespan:.1f} ms "
          f"({toks / makespan * 1e3:.1f} tok/s) | latency "
          f"p50 {np.percentile(ls, 50):.1f} ms "
          f"p99 {np.percentile(ls, 99):.1f} ms")
    if len(lat) != args.requests:
        raise SystemExit(f"served {len(lat)} of {args.requests} requests")
    return lat


if __name__ == "__main__":
    main()
