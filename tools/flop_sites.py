"""Print the per-layer FLOPs of port dry-run records, site by site.

    python -m tools.flop_sites RECORD.json [OTHER.json] [--top 20]

A record is what ``python -m repro_torch.launch.dryrun`` writes
(``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``).  Its
``flop_sites`` count each matmul-class op of the 1- and 2-layer runs by
op, operand shapes and call site; a site's per-layer FLOPs are its
2-layer count less its 1-layer count.  For each record the tool prints
the per-layer forward and backward FLOPs and their ratio: a site is the
backward's where autograd ran it (its innermost frame is
``bpt_trainer.value_and_grad``'s ``torch.autograd.grad``), the
forward's otherwise (the remat's recomputation included).  A dense with
its activations kept costs twice its forward in the backward (the
input's gradient and the weight's).  Given two records, it then lists the
sites whose per-layer FLOPs differ, the largest change first.
"""
from __future__ import annotations

import argparse
import inspect
import json

from repro_torch.core import bpt_trainer


def _grad_site() -> str:
    """``value_and_grad``'s ``torch.autograd.grad`` line as a frame."""
    lines, start = inspect.getsourcelines(bpt_trainer.value_and_grad)
    n = start + next(i for i, s in enumerate(lines)
                     if "torch.autograd.grad(" in s)
    return f"core/bpt_trainer.py:{n}"


def per_layer(record) -> dict:
    """{site: (calls, FLOPs)} a layer: the 2-layer run's less the
    1-layer run's, sites that cancel left out."""
    out = {}
    for run, sign in (("L2", 1), ("L1", -1)):
        for site, (n, flops) in record["flop_sites"][run].items():
            c, f = out.get(site, (0, 0))
            out[site] = (c + sign * n, f + sign * flops)
    return {k: v for k, v in out.items() if v != (0, 0)}


def split(sites) -> tuple:
    """(forward, backward) FLOPs of ``per_layer``'s sites."""
    grad = _grad_site()
    bwd = sum(f for k, (_, f) in sites.items()
              if k.split(" @ ")[1].startswith(grad))
    return sum(f for _, f in sites.values()) - bwd, bwd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("records", nargs="+", help="one or two record files")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)
    sites = []
    for fn in args.records[:2]:
        with open(fn) as f:
            record = json.load(f)
        sites.append(per_layer(record))
        fwd, bwd = split(sites[-1])
        print(f"{fn}: {record['arch']} {record['shape']} {record['mesh']}, "
              f"torch {record['torch']}; a layer: forward {fwd / 1e12:.4f} "
              f"T, backward {bwd / 1e12:.4f} T, backward / forward "
              f"{bwd / fwd:.4f}")
    if len(sites) == 2:
        a, b = sites
        diff = {k: (a.get(k, (0, 0)), b.get(k, (0, 0))) for k in a.keys()
                | b.keys() if a.get(k, (0, 0))[1] != b.get(k, (0, 0))[1]}
        print("calls, T a layer: first -> second, site")
        for k, ((ca, fa), (cb, fb)) in sorted(
                diff.items(), key=lambda kv: -abs(kv[1][1][1]
                                                  - kv[1][0][1]))[:args.top]:
            print(f"  {ca} x {fa / 1e12:.4f} -> {cb} x {fb / 1e12:.4f}  {k}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
