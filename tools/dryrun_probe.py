"""Hold the port's ``train_4k`` dry-run pairs to the JAX dry-run's
numbers on a host without JAX (a card host, whose torch may be another
version than the one the tests run on).

    python -m tools.dryrun_probe [--dir DIR] [ARCH ...]

Each pair (default: all ten) runs on ``tiny`` (2 x 2), its sequence cut
to 1024 tokens, as ``tests/test_torch_dryrun_train_collectives*.py`` run
it; its calibrated collective bytes at f32 width
(``dryrun.collectives_at_f32``: total, a layer, outside) are printed
beside REFERENCE's, with their ratios, and the record is saved to DIR
(default the dry-run's own directory) as
``<arch>__train_4k__tiny__probe.json``, for ``tools/coll_sites.py``.
Exit 1 if a pair fails or leaves the tests' band (1.5x total and a
layer, 2x outside, both ways).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

from repro_torch import configs
from repro_torch.launch import dryrun

SHAPE, MESH, SEQ = "train_4k", "tiny", 1024
BAND, OUTSIDE_BAND = 1.5, 2.0
# the reference's calibrated (total, per layer, outside) collective bytes
# at f32 width, its HLO's own (its collectives are f32): ``repro.launch.
# dryrun`` on the CPU (jax 0.9.0, 8 forced host devices), the reference
# side of ``tests/test_torch_dryrun_train_collectives*.py``
REFERENCE = {
    "yi-6b": (2854477758640, 87938039808, 40460484784),
    "phi3-mini-3.8b": (2276496867504, 70363840512, 24853971120),
    "gemma2-27b": (5668681564320, 121165643776, 95061950624),
    "stablelm-12b": (4626089410736, 114127339520, 60995829936),
    "internvl2-26b": (6742469017776, 138211098624, 108336283824),
    "qwen3-moe-30b-a3b": (16411492417712, 341274148864, 30333272240),
    "granite-moe-3b-a800m": (7639124770976, 238212401664, 16327917728),
    "mamba2-370m": (332135645232, 6724987904, 9336225840),
    "hymba-1.5b": (540265216160, 16427578720, 14582697120),
    "seamless-m4t-large-v2": (691093414288, 28441739264, 8491671952),
}


def ratios(record, arch) -> tuple:
    """(total, a layer, outside) of ``record`` at f32 width over
    REFERENCE's."""
    got = dryrun.collectives_at_f32(record)
    return tuple(g / w for g, w in zip(
        (got["coll_bytes"], got["per_layer"], got["outside"]),
        REFERENCE[arch], strict=True))


def in_band(r) -> bool:
    return all(1 / b <= x <= b for x, b in zip(
        r, (BAND, BAND, OUTSIDE_BAND), strict=True))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("archs", nargs="*", default=list(REFERENCE))
    ap.add_argument("--dir", default=dryrun.OUT_DIR)
    args = ap.parse_args(argv)
    configs.SHAPES[SHAPE] = dataclasses.replace(configs.SHAPES[SHAPE],
                                                seq_len=SEQ)
    os.makedirs(args.dir, exist_ok=True)
    faults = []
    for arch in args.archs:
        t0 = time.time()
        try:
            rec = dryrun.lower_and_compile(arch, SHAPE, MESH, verbose=False)
        except Exception as e:  # noqa: BLE001 — report every pair
            faults.append(f"{arch}: {e!r}"[:300])
            continue
        with open(os.path.join(args.dir, f"{arch}__{SHAPE}__{MESH}__probe"
                               ".json"), "w") as f:
            json.dump(rec, f)
        r = ratios(rec, arch)
        print(f"{arch} {SHAPE} {MESH} cut to {SEQ} tokens, torch "
              f"{rec['torch']}: total x{r[0]:.3f}, a layer x{r[1]:.3f}, "
              f"outside x{r[2]:.3f} the reference's at f32 width "
              f"({time.time() - t0:.0f} s)", flush=True)
        if not in_band(r) or rec["calibrated"]["outside"]["coll_bytes"] < 0:
            faults.append(f"{arch}: out of band {r}")
    for fault in faults:
        print("FAULT", fault)
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
