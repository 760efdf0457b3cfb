"""The paper's pipeline on the PyTorch/CUDA port: ``examples/train_bpt_cnn.py``
through ``repro_torch``.

Trains the Table-2 "case2" topology at 32 px with a widened FC stack
(``--fc-neurons``, 2000 by default) on 4 virtual heterogeneous nodes for a
few hundred optimizer steps with the full BPT-CNN stack (IDPA + AGWU or
SGWU over the outer layer, the hand-written kernels K1-K8 under every
conv, pool and dense layer on the card), and reports the accuracy trace,
the sync-wait and the communication volume.  It prints the model's
parameter count as it has it.

The params are drawn on the host from seed 0 and then placed on the
device, so a run on the card starts from the weights a CPU run starts
from, as the reference's ``PRNGKey(0)`` gives the same draw on any
backend.  (A CUDA generator draws other numbers from the same seed; its
seed-0 draw of this narrow conv stack starts at one class's accuracy
and does not train, on the CPU either.)

Run:  python examples/train_bpt_cnn_torch.py                  (on the card)
      python examples/train_bpt_cnn_torch.py --device cpu --small
(`pip install -e .` first.)
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.bpt_trainer import BPTTrainer, TrainHooks
from repro_torch.core.device import resolve_device
from repro_torch.core.engine import ENGINES, engine_config
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.core.types import TrainConfig
from repro_torch.data.pipeline import IDPADataset
from repro_torch.data.synthetic import image_dataset
from repro_torch.models.cnn import (CNNConfig, cnn_accuracy, cnn_loss,
                                    init_cnn)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--steps", type=int, default=240,
                    help="total optimizer steps across all nodes")
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=3)
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--fc-neurons", type=int, default=2000,
                    help="width of the FC stack (the paper's case5-7 FC "
                    "scale)")
    ap.add_argument("--strategy", choices=("sgwu", "agwu"), default="agwu")
    ap.add_argument("--engine", choices=sorted(ENGINES), default="",
                    help="select the outer-layer execution engine by name "
                    "(overrides --strategy/--device-outer; see "
                    "repro_torch.core.engine.ENGINES)")
    ap.add_argument("--device-outer", action="store_true",
                    help="ask for one node per device (falls back to the "
                    "fused node loop when fewer than --nodes devices "
                    "exist)")
    ap.add_argument("--uneven-batches", action="store_true",
                    help="IDPA-proportional per-node batch loads "
                    "(padded+masked stripes; needs --strategy sgwu)")
    ap.add_argument("--small", action="store_true",
                    help="tiny demo (fast)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)    # raises where no card is seen

    if args.small:
        args.fc_neurons, args.image_size, args.steps = 256, 16, 60

    cfg = CNNConfig(name="case2-wide", image_size=args.image_size,
                    conv_layers=4, filters=4, fc_layers=3,
                    fc_neurons=args.fc_neurons)
    params = tree_map(lambda x: x.to(device), init_cnn(
        cfg, torch.Generator("cpu").manual_seed(0), device="cpu"))
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"[bpt-cnn] model: {cfg.conv_layers} conv + {cfg.fc_layers} fc, "
          f"{n/1e6:.1f}M params, {args.image_size}px")

    xs, ys = image_dataset(4000, size=args.image_size, seed=0)
    xe, ye = image_dataset(800, size=args.image_size, seed=7)
    eval_batch = {"images": torch.from_numpy(xe).to(device),
                  "labels": torch.from_numpy(ye).to(device)}

    def eval_fn(p):
        return cnn_accuracy(p, eval_batch, cfg)

    speeds = 1.0 + 0.5 * np.arange(args.nodes)
    rounds = max(1, args.steps // (args.nodes * args.local_steps))
    ds = IDPADataset({"images": xs, "labels": ys}, num_nodes=args.nodes,
                     batches=min(3, rounds), frequencies=1.0 / speeds,
                     idpa_mode="balanced")
    common = dict(outer_nodes=args.nodes, optimizer="adamw",
                  learning_rate=1e-3, warmup_steps=10,
                  total_steps=args.steps, local_steps=args.local_steps,
                  uneven_batches=args.uneven_batches)
    if args.engine:     # engine selected by name through the engine API
        tc = TrainConfig(**engine_config(args.engine, **common))
    else:
        tc = TrainConfig(outer_strategy=args.strategy,
                         device_outer=args.device_outer, **common)
    trainer = BPTTrainer(lambda p, b: (cnn_loss(p, b, cfg), {}), params, ds,
                         tc, batch_size=32, eval_fn=eval_fn,
                         speed_factors=speeds)
    hooks = TrainHooks(on_round=lambda ev: print(
        f"[bpt-cnn]   event {ev.round + 1}: loss={ev.loss:.4f} "
        f"clock={ev.virtual_clock:.1f}s", flush=True))
    t0 = time.time()
    rep = trainer.train(rounds=rounds, hooks=hooks)
    print(f"[bpt-cnn] {rep.steps} pushes in {time.time()-t0:.0f}s wall "
          f"({rep.strategy}/{rep.backend} outer backend, on {device})")
    if rep.fallback:
        print(f"[bpt-cnn] engine fallback: {rep.fallback}")
    print(f"[bpt-cnn] accuracy trace: "
          f"{[(round(t,1), round(a,3)) for t, a in rep.accuracies]}")
    print(f"[bpt-cnn] IDPA allocation (samples/node): {rep.allocation}")
    print(f"[bpt-cnn] sync_wait={rep.sync_wait:.2f}s (AGWU -> 0) "
          f"comm={rep.comm_bytes/2**20:.1f}MB")
    # sanity: beat 10-class chance.  AGWU applies m x more global updates
    # than SGWU in the same --steps budget, so it clears a higher bar.
    floor = 0.3 if rep.strategy == "agwu" else 0.15
    assert rep.accuracies[-1][1] > floor, "should beat 10-class chance"
    return rep


if __name__ == "__main__":
    main()
