"""End-to-end training entry point of the port: the BPT-CNN outer layer over
an LM, the counterpart of ``repro/launch/train.py`` with its flags and
defaults, plus ``--device``:

    python -m repro_torch.launch.train --arch yi-6b --reduced \
        --outer agwu --partitioning idpa --rounds 8 --device cpu

``--device`` defaults to ``cuda`` (the kernels K1-K3 and K9 under every
projection and norm) and raises where no card is visible; ``--device cpu``
runs their plain PyTorch versions.  Params come from
``torch.Generator(device).manual_seed(seed)``, the corpus from numpy with
seed 0, as in the reference.  A config with a front end (InternVL2) draws
``--batch-size`` rows of stub patch embeddings once, from a generator of
the same seed, and every loss takes the first rows of them, as many as
its batch has.  Encoder-decoder configs are refused, as in the
reference.  ``--engine`` selects the outer-layer engine
by name (``repro_torch.core.engine.ENGINES``); ``--device-outer`` and
``--mesh`` resolve as ``engine.resolve_engine`` says, against the
visible CUDA devices (or one CPU device): with too few, a ``nodes4``
request falls back and prints ``[train] engine fallback: ...``, as the
reference does on one device.  ``run(..., devices=)`` passes a device
pool instead (four ``cuda:0`` run the sharded engines on one card).  ``--ckpt-dir`` saves the
final weights with ``checkpointing.checkpoint.save`` at step
``TrainReport.last_event``; ``--ckpt-every N`` also saves a weight and a
resumable train-state checkpoint every N merge events, and ``--resume``
restores the latest train-state checkpoint before the first round, as
the reference's flags do.

``run(args, cfg)`` is the CLI's body for any ``ModelConfig`` (a
depth-cut full-width config, say); ``main`` parses the flags and picks
the reduced or full config of ``--arch``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpointing import checkpoint
from repro_torch.core.bpt_trainer import BPTTrainer, TrainHooks
from repro_torch.core.device import resolve_device
from repro_torch.core.engine import ENGINES, engine_config
from repro_torch.core.faults import FaultSchedule
from repro_torch.core.tree import tree_leaves
from repro_torch.core.types import TrainConfig
from repro_torch.data.pipeline import IDPADataset, host_batch, pack_sequences
from repro_torch.data.synthetic import lm_corpus
from repro_torch.models import lm
from repro_torch.models.frontends import random_frontend_embeds

__all__ = ["build_lm_dataset", "make_parser", "run", "main"]


def build_lm_dataset(cfg, seq_len: int, num_rows: int, nodes: int,
                     batches: int, partitioning: str, frequencies):
    corpus = lm_corpus(num_rows * seq_len + 1, cfg.vocab_size, seed=0)
    rows = pack_sequences(corpus, seq_len)
    return IDPADataset({"rows": rows}, num_nodes=nodes, batches=batches,
                       frequencies=frequencies, partitioning=partitioning)


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b", choices=configs.ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--outer", default="agwu",
                    choices=["agwu", "sgwu", "sync"])
    ap.add_argument("--engine", default="", choices=sorted(ENGINES),
                    help="select the execution engine by name (overrides "
                    "--outer/--device-outer)")
    ap.add_argument("--device-outer", action="store_true",
                    help="shard the node axis over a real `nodes` device "
                    "mesh (one node per device; falls back to the fused "
                    "node loop when fewer than --nodes devices exist)")
    ap.add_argument("--mesh", default="",
                    help="named launch.mesh.MESHES entry for the node axis "
                    "(e.g. nodes4; needs a `nodes` axis of size --nodes); "
                    "empty = auto 1-D nodes mesh")
    ap.add_argument("--uneven-batches", action="store_true",
                    help="IDPA-proportional per-node batch loads "
                    "(padded+masked stripes; needs the SGWU stacked paths)")
    ap.add_argument("--partitioning", default="idpa",
                    choices=["idpa", "udpa"])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="",
                    help="save the final weights here")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save a weight checkpoint AND a resumable "
                    "train-state checkpoint into --ckpt-dir every N merge "
                    "events (0 = only the final weights)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest train-state checkpoint from "
                    "--ckpt-dir before the first round (a fresh dir just "
                    "starts from scratch — safe to always pass)")
    ap.add_argument("--faults", default="",
                    help="fault schedule: comma-separated "
                    "kind:node@event[xfactor] atoms, e.g. "
                    "'fail:1@3,rejoin:1@6,slow:2@4x2.5'")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def run(args, cfg, params=None, hooks=None, devices=None):
    """Train ``cfg`` as the flags in ``args`` say; returns the
    ``TrainReport``.  ``params`` (on ``args.device``) replaces the
    seeded init, e.g. to start from the reference's weights; ``hooks``
    (a ``TrainHooks``) observes each merge event through ``on_round``;
    ``--ckpt-every`` / ``--resume`` set its checkpoint fields;
    ``devices`` (a list of ``torch.device``) is the pool the engine is
    resolved against (``BPTTrainer(devices=)``)."""
    if args.ckpt_every:
        if not args.ckpt_dir:
            raise SystemExit("--ckpt-every needs --ckpt-dir")
        hooks = dataclasses.replace(
            hooks or TrainHooks(), checkpoint_every=args.ckpt_every,
            checkpoint_dir=args.ckpt_dir, resume=args.resume)
    elif args.resume:
        raise SystemExit("--resume needs --ckpt-every and --ckpt-dir")
    device = resolve_device(args.device)
    if cfg.arch_type == "encdec":
        raise SystemExit("use examples/train_bpt_cnn.py or a decoder arch "
                         "for the LM training CLI")
    print(f"[train] {cfg.name} ({cfg.arch_type}) reduced={args.reduced} "
          f"outer={args.outer} partitioning={args.partitioning} on {device}")
    if params is None:
        params = lm.init_params(
            cfg, torch.Generator(device).manual_seed(args.seed),
            device=device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] params: {n_params/1e6:.1f}M")
    frontend = random_frontend_embeds(
        torch.Generator(device).manual_seed(args.seed), cfg,
        args.batch_size, device=device)

    def loss_fn(p, batch):
        rows = batch["rows"]
        b = host_batch(rows)
        if "mask" in batch:
            # uneven stripes: padded rows (mask 0) carry no loss — label
            # them -1, which chunked_cross_entropy leaves out of the mean
            b["labels"] = b["labels"].masked_fill(
                batch["mask"][:, None] <= 0, -1)
        if frontend is not None:
            b["frontend_embeds"] = frontend[:rows.shape[0]]
        return lm.loss_fn(p, b, cfg)

    speeds = 1.0 + 0.4 * np.arange(args.nodes) / max(args.nodes - 1, 1)
    ds = build_lm_dataset(cfg, args.seq_len, args.rows, args.nodes,
                          batches=min(4, args.rounds),
                          partitioning=args.partitioning,
                          frequencies=1.0 / speeds)
    common = dict(learning_rate=args.lr, partitioning=args.partitioning,
                  outer_nodes=args.nodes, local_steps=args.local_steps,
                  warmup_steps=5, seed=args.seed,
                  total_steps=args.rounds * args.local_steps * args.nodes,
                  mesh_name=args.mesh, uneven_batches=args.uneven_batches)
    if args.engine:     # engine selected by name through the engine API
        tc = TrainConfig(**engine_config(args.engine, **common))
    else:
        tc = TrainConfig(outer_strategy=args.outer,
                         device_outer=args.device_outer, **common)
    faults = FaultSchedule.from_spec(args.faults, num_nodes=args.nodes) \
        if args.faults else None
    trainer = BPTTrainer(loss_fn, params, ds, tc,
                         batch_size=args.batch_size, speed_factors=speeds,
                         fault_schedule=faults, devices=devices)
    t0 = time.time()
    report = trainer.train(args.rounds, hooks)
    wall = time.time() - t0
    if report.fallback:
        print(f"[train] engine fallback: {report.fallback}")
    print(f"[train] done in {wall:.1f}s wall; report:")
    print(json.dumps(report.summary(), indent=2, default=str))
    if not report.losses:
        # --resume from a state checkpoint of an already-finished run:
        # nothing left to train, no new events
        print("[train] resumed past the final round; no new rounds ran")
        return report
    first, last = report.losses[0], report.losses[-1]
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    if args.ckpt_dir:
        # last_event, not steps: on a resumed run, steps counts only the
        # events this process produced and would mislabel the checkpoint
        path = checkpoint.save(args.ckpt_dir, report.final_params,
                               step=report.last_event,
                               metadata={"arch": cfg.name})
        print(f"[train] checkpoint: {path}")
    return report


def main(argv=None):
    args = make_parser().parse_args(argv)
    cfg = configs.get_reduced(args.arch) if args.reduced \
        else configs.get_config(args.arch)
    return run(args, cfg)


if __name__ == "__main__":
    main()
