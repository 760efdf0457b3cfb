"""Perf hill-climbing, from ``repro/launch/hillclimb.py``: a thin
search loop over planner candidates.  It needs no card.

Two modes, both scored by roofline terms:

* override mode: evaluate one (arch x shape x mesh) dry-run
  (``launch.dryrun``) with ModelConfig overrides and print/record its
  roofline row.

      python -m repro_torch.launch.hillclimb --arch gemma2-27b \\
          --shape train_4k --mesh pod --tag hc1a \\
          --set mlp_megatron=True --set attn_kv_gather=True

* plan mode (the CNN's 2-D hybrid mesh): enumerate ``(nodes, model)``
  axis splits of the device budget, score each with
  ``core.planner.plan_for_axes`` (per-layer inner cost) plus the Eq. 7
  merge all-reduce amortized over the local steps, and print the ranked
  candidates.  The search IS the planner: this loop owns no cost model
  of its own.

      python -m repro_torch.launch.hillclimb --plan \\
          --cnn case1 --devices 8 --batch-size 32

(``pip install -e .`` first, or prefix ``PYTHONPATH=src``.)
"""
from __future__ import annotations

import argparse
import dataclasses
import json

__all__ = ["parse_value", "plan_search", "main"]


def parse_value(v: str):
    if v in ("True", "False"):
        return v == "True"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def _axis_splits(budget: int):
    """Power-of-2 ``(nodes, model)`` splits fitting the device budget."""
    out = []
    n = 1
    while n <= budget:
        k = 1
        while n * k <= budget:
            out.append((n, k))
            k *= 2
        n *= 2
    return out


def plan_search(cnn: str, devices: int, batch_size: int,
                local_steps: int = 2) -> list[dict]:
    """Rank hybrid-mesh candidates for a CNN config by total round cost.

    Per candidate: the planner's per-layer inner cost (already / model
    shards), plus the ring all-reduce of one weight replica over
    ``nodes`` (the Eq. 7 merge) amortized over the local steps.  Ranked
    by cost per GLOBAL sample: a step processes ``nodes * B`` samples,
    so outer data parallelism's throughput counts against its merge
    traffic instead of every split losing to (1, 1).
    """
    from repro_torch.core import planner
    from repro_torch.launch import roofline
    from repro_torch.models.cnn import make_case

    cfg = make_case(cnn)
    hw = roofline.HW()
    rows = []
    for nodes, model in _axis_splits(devices):
        try:
            plan = planner.plan_for_axes(cfg, nodes=nodes, model=model,
                                         batch_size=batch_size, hw=hw)
        except ValueError:
            continue
        wbytes = planner.network_param_bytes(cfg)
        merge = 2.0 * (nodes - 1) / nodes * wbytes / hw.ici_bw \
            if nodes > 1 else 0.0
        cost = plan.total_cost_s + merge / max(local_steps, 1)
        rows.append({
            "nodes": nodes, "model": model, "family": plan.family,
            "inner_cost_s": plan.total_cost_s,
            "merge_cost_s_per_step": merge / max(local_steps, 1),
            "step_cost_s": cost,
            "cost_per_sample_s": cost / (nodes * batch_size),
            "layers": [{"name": lp.name, "dim": lp.parallel_dim,
                        "tile": lp.tile} for lp in plan.layers],
        })
    rows.sort(key=lambda r: r["cost_per_sample_s"])
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--plan", action="store_true",
                    help="rank (nodes, model) hybrid-mesh splits for a CNN")
    ap.add_argument("--cnn", default="case1",
                    help="Table 2 case name (plan mode)")
    ap.add_argument("--devices", type=int, default=8,
                    help="device budget to split (plan mode)")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod")
    ap.add_argument("--tag")
    ap.add_argument("--variant", default="")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-calibrate", action="store_true",
                    help="leave the calibrated costs and the roofline row "
                         "out of the record")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE", help="ModelConfig overrides")
    args = ap.parse_args(argv)

    if args.plan:
        rows = plan_search(args.cnn, args.devices, args.batch_size,
                           args.local_steps)
        print(f"[hillclimb:plan] {args.cnn} over {args.devices} devices "
              f"B={args.batch_size}")
        print(json.dumps(rows, indent=1))
        return 0

    if not (args.arch and args.shape and args.tag):
        ap.error("override mode needs --arch, --shape and --tag "
                 "(or use --plan)")
    from repro_torch import configs
    from repro_torch.launch import dryrun
    cfg = configs.get_config(args.arch, args.variant)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = parse_value(v)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    print(f"[hillclimb:{args.tag}] {args.arch} x {args.shape} x {args.mesh} "
          f"overrides={overrides}")
    res = dryrun.lower_and_compile(args.arch, args.shape, args.mesh,
                                   variant=args.variant,
                                   remat=not args.no_remat,
                                   calibrate=not args.no_calibrate,
                                   cfg_override=cfg)
    res["overrides"] = overrides
    fn = dryrun.save_result(res, tag=args.tag)
    print(f"  -> {fn}")
    if "roofline" in res:
        print(json.dumps(res["roofline"], indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
