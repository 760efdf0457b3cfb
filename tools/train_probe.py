"""Held-out trajectories of a language model trained through the port,
under variants that take its parts out one at a time.

    PYTHONPATH=src python3 tools/train_probe.py --arch hymba-1.5b \
        --steps 100 --variants kernels,plain,attn,mixer,lr=3e-4

Each variant trains ``--arch`` at full width and LAYERS layers from
the same seed as ``chip_smoke.py``'s phases 4e and 4k train it (B 8 x S
128 from ``lm_corpus``, AdamW at lr 1e-3, warmup 2 then cosine over the
steps, grad_clip 1.0), and prints a held-out batch's CE, its excess
over ln V, and the spread of its logits (their standard deviation over
the vocabulary, averaged over positions) every 10 steps:

- ``kernels``: the port as it runs (K1-K3 and K9 on the card);
- ``plain``: ``ops.dense`` and ``ops.rmsnorm`` swapped, in this script,
  for their plain PyTorch versions (``kernels/ref.py``), autograd through
  them, on the same tensors;
- ``seqssd``: the mixer's chunked SSD swapped for the sequential
  recurrence ``mamba.ssd_reference``;
- ``attn`` and ``mixer``: one branch of the block, ``arch_type`` "dense"
  (attention and the MLP) or "ssm" (the mixer alone), the widths kept;
- ``lr=X``: the kernels at peak lr X.

First, one batch's loss and every gradient leaf at the initial params,
``kernels`` against ``plain``, leaf by leaf (relative L2 error and max
abs diff).  The swaps live here only: the port itself has no plain path
on the card.  Needs one card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import time

import torch

from repro_torch import configs
from repro_torch.core import bpt_trainer
from repro_torch.core.types import TrainConfig
from repro_torch.data import pipeline, synthetic
from repro_torch.kernels import ops, ref
from repro_torch.models import lm, mamba
from repro_torch.optim import optimizers
from repro_torch.core.tree import tree_leaves

B, S, HELD_EVERY, LR = 8, 128, 10, 1e-3
LAYERS = 8                       # phases 4e, 4h and 4k's depth


@contextlib.contextmanager
def swapped(variant):
    """``plain`` and ``seqssd``'s swaps for the duration of a block."""
    saved = ops.dense, ops.rmsnorm, mamba.ssd_chunked
    if variant == "plain":
        ops.dense = lambda x, w, b=None, activation="none": ref.dense_ref(
            x, w.to(x.dtype), b, activation)
        ops.rmsnorm = ref.rmsnorm_ref
    elif variant == "seqssd":
        def seq(x, dt, A, B, C, D, chunk=256, return_final_state=False):
            assert not return_final_state
            return mamba.ssd_reference(x, dt, A, B, C, D)
        mamba.ssd_chunked = seq
    try:
        yield
    finally:
        ops.dense, ops.rmsnorm, mamba.ssd_chunked = saved


def variant_config(cfg, variant):
    if variant == "attn":
        return dataclasses.replace(cfg, arch_type="dense")
    if variant == "mixer":
        return dataclasses.replace(cfg, arch_type="ssm")
    return cfg


def make_batches(cfg, steps):
    """``steps`` training batches, 2 more (as phase 4e draws them for its
    profile), then the held-out one: phase 4e's corpus and order."""
    corpus = synthetic.lm_corpus((steps + 3) * B * S + 1, cfg.vocab_size,
                                 seed=0)
    rows = pipeline.pack_sequences(corpus, S)
    return [{"rows": torch.as_tensor(rows[None, i * B:(i + 1) * B],
                                     device="cuda")}
            for i in range(steps + 3)]


def held_out(params, cfg, rows):
    """(CE, mean over positions of the logits' std over the vocabulary)."""
    with torch.no_grad():
        batch = pipeline.host_batch(rows)
        _, parts = lm.loss_fn(params, batch, cfg)
        hidden, _, _ = lm.forward(lm.compute_params(params, cfg),
                                  batch["tokens"], cfg)
        table = params.get("lm_head", params["embed"])["table"]
        logits = (hidden @ table.to(hidden.dtype).T).float()
        return float(parts["ce"]), float(logits.std(dim=-1).mean())


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def compare_grads(cfg, batch):
    """One batch's loss and every grad leaf, kernels against plain."""
    params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0))

    def loss_fn(p, b):
        return lm.loss_fn(p, pipeline.host_batch(b["rows"][0]), cfg)
    out = {}
    for variant in ("kernels", "plain"):
        with swapped(variant):
            (loss, _), grads = bpt_trainer.value_and_grad(loss_fn, params,
                                                          batch)
        out[variant] = float(loss), dict(_named(grads))
    (lk, gk), (lp, gp) = out["kernels"], out["plain"]
    print(f"[grads] {cfg.name} {cfg.num_layers} layers, first batch: loss "
          f"kernels {lk:.6f}, plain {lp:.6f}")
    worst = 0.0
    for name, g in gp.items():
        d = (gk[name].float() - g.float())
        rel = float(d.norm() / g.float().norm().clamp_min(1e-30))
        worst = max(worst, rel)
        print(f"[grads] {name} {tuple(g.shape)}: rel L2 {rel:.3e}, max abs "
              f"diff {float(d.abs().max()):.3e} (|g| max "
              f"{float(g.abs().max()):.3e})")
    print(f"[grads] worst rel L2 over {len(gp)} leaves: {worst:.3e}")


def train(cfg, variant, steps):
    lr = float(variant[3:]) if variant.startswith("lr=") else LR
    vcfg = variant_config(cfg, variant)
    params = lm.init_params(vcfg, torch.Generator("cuda").manual_seed(0))
    batches = make_batches(vcfg, steps)
    held = batches[-1]["rows"][0]

    def loss_fn(p, b):
        return lm.loss_fn(p, pipeline.host_batch(b["rows"]), vcfg)
    tc = TrainConfig(optimizer="adamw", learning_rate=lr, warmup_steps=2,
                     total_steps=steps, grad_clip=1.0, local_steps=1)
    state = optimizers.make_optimizer("adamw").init(params)
    node_round = bpt_trainer.make_node_round(loss_fn, tc)
    n = sum(t.numel() for t in tree_leaves(params))
    log_v = math.log(vcfg.vocab_size)
    readings = [(0, held_out(params, vcfg, held))]
    t0 = time.perf_counter()
    with swapped(variant):
        for i in range(steps):
            params, state, _ = node_round(params, state, batches[i], i)
            if (i + 1) % HELD_EVERY == 0 or i + 1 == steps:
                readings.append((i + 1, held_out(params, vcfg, held)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"[train] {variant}: {vcfg.name} arch_type {vcfg.arch_type}, "
          f"{vcfg.num_layers} layers, {n} params, lr {lr:g}, {steps} steps "
          f"in {wall:.1f} s; held-out CE (CE - ln V, logit std) after step "
          + ", ".join(f"{i}: {ce:.4f} ({ce - log_v:+.4f}, {sd:.3f})"
                      for i, (ce, sd) in readings))
    del params, state, batches
    torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="hymba-1.5b",
                    choices=configs.ARCH_NAMES)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--variants", default="kernels,plain")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_probe: torch sees no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {torch.cuda.get_device_name(0)}")
    cfg = dataclasses.replace(configs.get_config(args.arch),
                              num_layers=LAYERS)
    compare_grads(cfg, make_batches(cfg, 1)[0])
    for variant in args.variants.split(","):
        train(cfg, variant, args.steps)


if __name__ == "__main__":
    main()
