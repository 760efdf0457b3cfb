"""Quickstart on the PyTorch/CUDA port: ``examples/quickstart.py`` through
``repro_torch``.

Trains the paper's CNN (Table 2 scale, reduced images) on a heterogeneous
virtual cluster with IDPA partitioning, under the synchronous SGWU merge
and the AGWU asynchronous parameter server, and prints one summary line
per strategy.  On the card every conv, pool and dense layer runs through
the hand-written kernels K1-K8.

Run:  python examples/quickstart_torch.py                 (on the card)
      python examples/quickstart_torch.py --device cpu    (plain PyTorch)
(`pip install -e .` first.)
"""
import argparse

import numpy as np
import torch

from repro_torch.core.bpt_trainer import BPTTrainer
from repro_torch.core.device import resolve_device
from repro_torch.core.types import TrainConfig
from repro_torch.data.pipeline import IDPADataset
from repro_torch.data.synthetic import image_dataset
from repro_torch.models.cnn import (CNNConfig, cnn_accuracy, cnn_loss,
                                    init_cnn)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)    # raises where no card is seen

    # --- the paper's CNN (scaled to 16px for a quick demo) ---
    cfg = CNNConfig(name="quickstart", image_size=16, conv_layers=2,
                    filters=8, fc_layers=2, fc_neurons=64)
    xs, ys = image_dataset(2000, size=16, seed=0)
    xe, ye = image_dataset(500, size=16, seed=42)
    params = init_cnn(cfg, torch.Generator(device.type).manual_seed(0),
                      device=device)
    eval_batch = {"images": torch.from_numpy(xe).to(device),
                  "labels": torch.from_numpy(ye).to(device)}

    def eval_fn(p):
        return cnn_accuracy(p, eval_batch, cfg)

    # --- a 4-node heterogeneous virtual cluster (speeds 1x..2.2x) ---
    speeds = np.array([1.0, 1.3, 1.7, 2.2])
    for strategy in ("sgwu", "agwu"):
        ds = IDPADataset({"images": xs, "labels": ys}, num_nodes=4,
                         batches=3, frequencies=1.0 / speeds,
                         partitioning="idpa", idpa_mode="balanced")
        tc = TrainConfig(outer_strategy=strategy, outer_nodes=4,
                         optimizer="adamw", learning_rate=2e-3,
                         warmup_steps=10, total_steps=400, local_steps=4)
        trainer = BPTTrainer(lambda p, b: (cnn_loss(p, b, cfg), {}),
                             params, ds, tc, batch_size=64,
                             eval_fn=eval_fn, speed_factors=speeds)
        rep = trainer.train(rounds=args.rounds)
        s = rep.summary()
        print(f"{strategy.upper():5s} acc={s['final_acc']:.3f} "
              f"virtual_makespan={s['makespan']:.2f}s "
              f"sync_wait={s['sync_wait']:.2f}s comm={s['comm_MB']}MB "
              f"allocation={rep.allocation}")
    print("\nAGWU trains with zero synchronisation wait (the paper's point);"
          "\nIDPA gave the fast nodes proportionally more samples.")


if __name__ == "__main__":
    main()
