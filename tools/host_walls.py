"""Host walls of the port's served decode step and prefill on the card.

    PYTHONPATH=src python tools/host_walls.py [--model yi-6b:0] \\
        [--model qwen3-moe-30b-a3b:8] [--steps 40] [--prompt 1024]

For each ``ARCH:LAYERS`` (0: every layer) a served model at full width
from a seeded generator: 4 slots filled by a 16-token prefill each, two
warm-up decode steps, then ``--steps`` decode steps of the 4 slots, each
timed on the host's clock up to the card's synchronize; then three
prefills of one ``--prompt``-token prompt, timed the same way after a
warm-up one.  Decode steps are host-paced, so these walls are what a
change to the host's path per layer moves.

Prints one JSON line per model (decode walls in ms: all, median,
fastest; prefill walls in ms) with the card's name and power limit and
torch's version.  Point ``PYTHONPATH`` at another checkout's ``src`` to
time that commit's package with the same script: two commits compare
within one machine call, run in turns (A, B, B, A).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def walls(arch: str, layers: int, steps: int, prompt_len: int) -> dict:
    import dataclasses

    import repro_torch
    from repro_torch import configs, serving
    from repro_torch.models import lm
    cfg = configs.get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            device="cuda")
    eng = serving.make_serve_engine(params, cfg, serving.ServeConfig(
        slots=4, max_seq=prompt_len + 64), device="cuda")
    rng = np.random.default_rng(1)
    _, sl, _ = eng.prefill(rng.integers(0, cfg.vocab_size, (4, 16)))
    for slot in range(4):
        eng.insert(sl, slot, row=slot)
    toks = rng.integers(0, cfg.vocab_size, (4,))
    for _ in range(2):
        eng.decode(toks)
    torch.cuda.synchronize()
    dec = []
    for _ in range(steps):
        t0 = time.perf_counter()
        eng.decode(toks)
        torch.cuda.synchronize()
        dec.append((time.perf_counter() - t0) * 1e3)
    prompt = rng.integers(0, cfg.vocab_size, (1, prompt_len))
    pre = []
    for _ in range(4):
        t0 = time.perf_counter()
        eng.prefill(prompt)
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
    del params, eng, sl
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": cfg.num_layers, "package":
            repro_torch.__file__, "decode_ms": dec,
            "decode_median_ms": statistics.median(dec),
            "decode_fastest_ms": min(dec), "prompt": prompt_len,
            "prefill_ms": pre[1:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", action="append",
                    help="ARCH:LAYERS (0: every layer); repeatable")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--prompt", type=int, default=1024)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("host_walls: no card")
    name = card()
    for spec in args.model or ["yi-6b:0", "qwen3-moe-30b-a3b:8"]:
        arch, layers = spec.split(":")
        with torch.inference_mode():
            row = walls(arch, int(layers), args.steps, args.prompt)
        row.update(card=name, torch=torch.__version__)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
