"""Training worker for the port's SIGKILL chaos test
(``tests/test_torch_chaos.py``), from ``tests/chaos_worker.py``.

Runs a small deterministic fused-SGWU (``vmap``) training job on the port,
checkpointing params AND resumable train state after every merge event,
printing ``EVENT n`` after each event so the parent can kill it mid-run.
``--resume`` restores the latest state checkpoint first — a killed run
relaunched with the same command line continues losslessly.  The final
merged weights are published as step ``FINAL_STEP`` so the parent can
compare runs.

``--case chaos`` (the default) is the chaos suite's tiny CNN; ``--case
case7`` is Table-2 case7 at full width, for the card.  ``--device``
defaults to ``cpu``.

Not a test file: run as ``python tests/torch_chaos_worker.py`` with the
port importable (``pip install -e .``), by ``test_torch_chaos.py`` and by
``chip_smoke.py`` (phase 4p(b)).  It imports no JAX and nothing of the
reference package.
"""
import argparse

FINAL_STEP = 10_000


def build_trainer(nodes: int, seed: int = 0, device: str = "cpu",
                  case: str = "chaos"):
    import torch

    from repro_torch.core.bpt_trainer import BPTTrainer
    from repro_torch.core.device import resolve_device
    from repro_torch.core.types import TrainConfig
    from repro_torch.data.pipeline import IDPADataset
    from repro_torch.data.synthetic import image_dataset
    from repro_torch.models.cnn import CNNConfig, cnn_loss, init_cnn, make_case

    dev = resolve_device(device)
    if case == "chaos":
        cfg = CNNConfig(name="chaos", image_size=8, conv_layers=1, filters=4,
                        fc_layers=1, fc_neurons=32)
        batch_size = 16
    else:
        cfg = make_case(case)
        batch_size = 64
    xs, ys = image_dataset(64 * nodes * 2, size=cfg.image_size, seed=0)
    params = init_cnn(cfg, torch.Generator(dev.type).manual_seed(0),
                      device=dev)
    # batches=1: the allocation is settled up front, so the only inter-run
    # nondeterminism (measured durations feeding IDPA) is out of play and
    # the resumed trajectory must be BIT-identical to the uninterrupted one
    ds = IDPADataset({"images": xs, "labels": ys}, num_nodes=nodes,
                     batches=1)
    tc = TrainConfig(outer_nodes=nodes, outer_strategy="sgwu",
                     fused_outer=True, optimizer="adamw",
                     learning_rate=2e-3, total_steps=100, warmup_steps=5,
                     local_steps=2, seed=seed)
    return BPTTrainer(lambda p, b: (cnn_loss(p, b, cfg), {}), params, ds,
                      tc, batch_size=batch_size)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--case", default="chaos",
                    help="'chaos' (the tiny CNN) or a Table-2 case, e.g. "
                    "case7")
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.checkpointing import checkpoint
    from repro_torch.core.bpt_trainer import TrainHooks

    if args.device.startswith("cuda"):
        import torch
        # the chaos runs compare bits: no TF32 in any plain op on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    tr = build_trainer(args.nodes, seed=args.seed, device=args.device,
                       case=args.case)
    hooks = TrainHooks(checkpoint_every=1, checkpoint_dir=args.ckpt_dir,
                       resume=args.resume)
    last = None
    for ev in tr.run(args.rounds, hooks):
        last = ev
        # the checkpoint for this event is already on disk (run() saves
        # before yielding) — the parent may SIGKILL us any time after this
        print(f"EVENT {ev.round}", flush=True)
    checkpoint.save(args.ckpt_dir, last.params, step=FINAL_STEP)
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
