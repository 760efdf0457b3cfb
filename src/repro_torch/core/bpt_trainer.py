"""BPTTrainer — the paper's bi-layered training loop, from
``repro/core/bpt_trainer.py``.

Outer layer: m virtual computing nodes (data-parallel groups).  Each node
pulls the global weights from the ParameterServer, runs ``local_steps``
train steps on its IDPA-assigned data stripe, and pushes back under SGWU
(barrier, Eq. 7) or AGWU (event-ordered, Eq. 9-10).  Node heterogeneity is
emulated with per-node speed factors scaling measured step times into
virtual completion times — the event order (and therefore the staleness
pattern AGWU sees) is exactly the paper's.

The execution substrates are the engines of ``core.engine``;
``engine.resolve_engine`` maps a TrainConfig (and the device pool, the
trainer's ``devices=``) to one of them and records a device-count
fallback on ``TrainReport.fallback``.  On a mesh, node j's round runs on
node j's device (``_get_device_round``); on a 2-D ``(nodes, model)`` mesh
it runs the per-layer plan of ``core.planner``.

Two entry points:

- ``run(rounds, hooks)`` — a generator yielding one ``RoundEvent`` per
  merge (per round for SGWU/sync, per push for AGWU) so callers stream
  losses, evaluate on their own cadence, checkpoint mid-run and
  early-stop.  ``TrainHooks`` supplies the eval / checkpoint / callback
  cadences, and ``resume`` continues a killed run from its latest state
  checkpoint.
- ``train(rounds, hooks)`` — drains ``run`` into a ``TrainReport``.

Inner layer: the local step, ``make_step_body`` (value and grad, clip by
global norm, the ``warmup_cosine`` learning rate, the optimizer update,
``apply_updates``) and ``make_node_round`` (``local_steps`` of it,
returning the last loss); on a CUDA device the CNN's layers run through
the hand-written kernels K1-K8.

``loss_fn(params, batch) -> (loss, aux)`` as in the reference.  Params,
optimizer state and batches are nested dicts and lists of tensors; a step
returns new ones and changes none of its inputs.  Batches come from the
dataset as numpy and are placed on the params' device in one transfer per
round (per local step on the per-node paths), each upload a sanctioned
sync of the sanitizer (``repro_torch.sanitize``, label ``upload``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpointing import checkpoint
from repro_torch.core import planner
from repro_torch.core.engine import RoundEvent, TrainHooks, resolve_engine
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.core.types import TrainConfig
from repro_torch.data.pipeline import IDPADataset
from repro_torch.launch.mesh import place
from repro_torch.optim.optimizers import (apply_updates, clip_by_global_norm,
                                          make_optimizer, warmup_cosine)
from repro_torch.sanitize import sanctioned_scope, sanctioned_sync

__all__ = ["value_and_grad", "make_step_body", "make_node_round",
           "BPTTrainer", "TrainReport", "TrainHooks", "RoundEvent"]


def value_and_grad(loss_fn, params, batch):
    """((loss, aux), grads) of ``loss_fn`` at ``params``, grads shaped like
    ``params``; ``params`` themselves are left outside autograd."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, aux = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), aux), tree_unflatten(params, grads)


def _split_grads(loss_fn, combine):
    """``(loss, grads)`` of one batch split over the model devices of the
    active plan scope: shard k takes rows k*B/K .. (k+1)*B/K on device k,
    with the params placed there, and ``combine`` (``planner.
    grad_combine``) weights and sums the shards' values on the params'
    device."""

    def grads_fn(params, batch):
        devices = planner.current_devices()
        home = tree_leaves(params)[0].device
        rows = tree_leaves(batch)[0].shape[0]
        blk = rows // len(devices)
        losses, grads, shards = [], [], []
        for k, device in enumerate(devices):
            shard = place({key: v[k * blk:(k + 1) * blk]
                           for key, v in batch.items()}, device)
            (loss, _), g = value_and_grad(loss_fn, place(params, device),
                                          shard)
            losses.append(loss)
            grads.append(g)
            shards.append(shard)
        return combine(losses, grads, shards, home)

    return grads_fn


def make_step_body(loss_fn, train_cfg: TrainConfig, combine=None):
    """``step_body(params, opt_state, batch, step) -> (params, opt_state,
    loss)``: one optimizer step, the reference's order of operations.
    ``combine`` (a batch-family plan's ``planner.grad_combine``) splits the
    batch over the scope's model devices and recombines the shards' loss
    and gradients BEFORE clipping, so the clip sees the same global norm
    the unsplit paths clip."""
    opt = make_optimizer(train_cfg.optimizer)
    schedule = warmup_cosine(train_cfg.learning_rate, train_cfg.warmup_steps,
                             train_cfg.total_steps)
    grad_clip = train_cfg.grad_clip
    split = _split_grads(loss_fn, combine) if combine is not None else None

    def step_body(params, opt_state, batch, step):
        if split is not None:
            loss, grads = split(params, batch)
        else:
            (loss, _), grads = value_and_grad(loss_fn, params, batch)
        if grad_clip:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        updates, opt_state = opt.update(grads, opt_state, params,
                                        schedule(step))
        return apply_updates(params, updates), opt_state, loss

    return step_body


def make_node_round(loss_fn, train_cfg: TrainConfig, combine=None):
    """``node_round(params, opt_state, batches, step) -> (params,
    opt_state, last loss)``: one node's local iteration.  ``batches``
    leaves carry a leading ``local_steps`` axis; ``step`` is the round
    index, held constant over the local steps as the reference's scan
    holds it.  ``combine``: as ``make_step_body``'s."""
    step_body = make_step_body(loss_fn, train_cfg, combine)

    def node_round(params, opt_state, batches, step):
        steps = len(tree_leaves(batches)[0])
        loss = None
        for s in range(steps):
            batch = {k: v[s] for k, v in batches.items()}
            params, opt_state, loss = step_body(params, opt_state, batch,
                                                step)
        return params, opt_state, loss

    return node_round


@dataclasses.dataclass
class TrainReport:
    strategy: str
    steps: int
    losses: list
    accuracies: list            # (virtual_time, accuracy) pairs
    virtual_makespan: float
    sync_wait: float
    comm_bytes: int
    allocation: np.ndarray
    final_params: object = None
    # which outer-layer execution backend actually ran: "device" (node j
    # on mesh device j), "vmap" (stacked single-device round),
    # "sequential" (per-node loop), "heap"/"heap-device" (AGWU), "scan"
    # (sync baseline).  The device paths fall back to "vmap"/"heap" when
    # the pool has too few devices — callers can assert on this.
    backend: str = ""
    # non-empty when the executed backend differs from the requested one
    # (the EnginePlan's recorded device-count fallback reason)
    fallback: str = ""
    # global index just past the last event (= its round + 1); differs
    # from ``steps`` when the run resumed from a state checkpoint, where
    # ``steps`` counts only the events this process produced
    last_event: int = 0

    def summary(self) -> dict:
        out = {
            "strategy": self.strategy,
            "backend": self.backend,
            "steps": self.steps,
            "final_loss": round(float(self.losses[-1]), 4) if self.losses else None,
            "final_acc": round(float(self.accuracies[-1][1]), 4)
            if self.accuracies else None,
            "makespan": round(self.virtual_makespan, 3),
            "sync_wait": round(self.sync_wait, 3),
            "comm_MB": round(self.comm_bytes / 2**20, 2),
        }
        if self.fallback:
            out["fallback"] = self.fallback
        return out


class BPTTrainer:
    def __init__(self,
                 loss_fn: Callable,                 # (params, batch) -> (loss, aux)
                 init_params,
                 dataset: IDPADataset,
                 train_cfg: TrainConfig,
                 batch_size: int,
                 eval_fn: Optional[Callable] = None,   # (params) -> accuracy
                 speed_factors: Optional[Sequence[float]] = None,
                 accuracy_weighting: str = "normalized",
                 model_cfg=None,
                 plan_family: str = "",
                 fault_schedule=None,
                 devices: Optional[Sequence] = None):
        # accuracy_weighting:
        #   "paper"      — Eq. (10) verbatim: scale = gamma * Q.
        #   "normalized" — Q is divided by its running mean, so the relative
        #     contribution weighting the paper wants is kept while the
        #     update magnitude stays ~gamma.
        self.loss_fn = loss_fn
        self.dataset = dataset
        self.tc = train_cfg
        self.batch_size = batch_size
        self.eval_fn = eval_fn
        # optional model config (a CNNConfig): lets the 2-D hybrid-mesh
        # engine plan per-layer parallelization (core.planner); without it
        # a 2-D mesh runs the generic batch-family plan.  ``plan_family``
        # forces a planner family ("batch"/"channel"); "" lets the cost
        # model pick.
        self.model_cfg = model_cfg
        self.plan_family = plan_family
        # the device pool resolve_engine decides against (the reference
        # reads jax.devices() there): a list of torch.device, the same
        # device repeated to emulate several; None counts the CUDA devices
        # when the params are on the card, else the params' one device
        self.devices = None if devices is None else list(devices)
        self.m = train_cfg.outer_nodes
        # optional FaultSchedule (core.faults): node churn the engines
        # replay — fail/rejoin/slow transitions keyed on event indices
        self.faults = fault_schedule
        if fault_schedule is not None and not fault_schedule.empty:
            fault_schedule.validate_nodes(self.m)
        self.speed = np.asarray(speed_factors if speed_factors is not None
                                else np.ones(self.m), np.float64)
        self.opt = make_optimizer(train_cfg.optimizer)
        self.params0 = init_params
        # batches follow the params: their device is the trainer's
        self.device = tree_leaves(init_params)[0].device
        self.rng = np.random.default_rng(train_cfg.seed)
        self.accuracy_weighting = accuracy_weighting
        self._q_ema = None
        self.last_plan = None        # EnginePlan of the most recent run()
        self.last_engine = None      # engine instance of the most recent run()
        self._train_step = make_step_body(loss_fn, train_cfg)
        self._node_round = make_node_round(loss_fn, train_cfg)

    def _q_effective(self, q: float) -> float:
        """Relative contribution weight Q (see accuracy_weighting above)."""
        q = max(q, 1e-3)
        if self.accuracy_weighting == "paper":
            return q
        self._q_ema = q if self._q_ema is None else \
            0.9 * self._q_ema + 0.1 * q
        return float(np.clip(q / max(self._q_ema, 1e-3), 0.25, 2.0))

    def _to_device(self, batch: dict, device=None) -> dict:
        """A numpy batch on ``device`` (default the trainer's; one copy a
        leaf): the explicit placement of the reference's ``device_put``.
        From pageable host memory the copy waits for the card, so it is a
        sanctioned sync (label ``upload``)."""
        device = self.device if device is None else device
        with sanctioned_scope("upload"):
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    .to(device) for k, v in batch.items()}

    # ------------------------------------------------------------------
    def _local_round(self, params, opt_state, node: int, step: int):
        """One node's local iteration: ``local_steps`` steps on its stripe.
        Returns (params, opt_state, loss, duration)."""
        t0 = time.perf_counter()
        loss = None
        device = tree_leaves(params)[0].device    # the node's device
        for _ in range(self.tc.local_steps):
            batch = self._to_device(
                self.dataset.node_batch(node, self.batch_size, self.rng),
                device)
            params, opt_state, loss = self._train_step(
                params, opt_state, batch, step)
        # the Eq. 8 measurement boundary: the host read waits for the
        # device — a sanctioned sync, not a hidden one
        loss = float(sanctioned_sync(loss, "local-round.loss"))
        wall = time.perf_counter() - t0
        return params, opt_state, loss, wall * self.speed[node]

    def _stacked_round(self, stacked_w, stacked_opt, batches, step):
        """The m node rounds of one stacked SGWU round: node j's round runs
        on slice j of the stacked params, optimizer state and batches
        (leaves ``(m, local_steps, B, ...)``), and its results are written
        back into slice j.  Returns the stacks and the (m,) last losses."""
        losses = []
        for j in range(self.m):
            w, s, loss = self._node_round(
                self._node_slice(stacked_w, j),
                self._node_slice(stacked_opt, j),
                self._node_slice(batches, j), step)
            tree_map(lambda dst, src: dst[j].copy_(src), stacked_w, w)
            tree_map(lambda dst, src: dst[j].copy_(src), stacked_opt, s)
            losses.append(loss)
        return stacked_w, stacked_opt, torch.stack(losses)

    def _get_device_round(self, mesh, netplan=None, executed=None):
        """The round of a mesh engine: ``round_fn(stacked_w, stacked_opt,
        batches, step) -> (stacked_w, stacked_opt, losses)`` over
        node-sharded stacks (lists of m trees, node j's on its mesh
        device) and ``batches`` as ``_place_node_batches`` gives them.
        Node j's ``make_node_round`` runs on node j's device, one node
        after another (one controller drives every device, as the
        reference's ``shard_map`` does).

        On a 2-D ``(nodes, model)`` mesh the round executes ``netplan``
        (``core.planner.NetworkPlan``) under a ``plan_scope`` holding the
        node's model-axis devices: a batch-family plan splits the node's
        stripe over them and recombines the shards' loss and gradients
        with the exact sample-count-weighted ``grad_combine``; a
        channel-family plan's fc layers go column-parallel in
        ``kernels.ops``.  ``executed`` (a list) receives the LayerPlans
        the first node round's first forward consumed, once."""
        node_round = self._node_round
        if netplan is not None and netplan.combine_grads:
            node_round = make_node_round(self.loss_fn, self.tc,
                                         planner.grad_combine(netplan))

        def round_fn(stacked_w, stacked_opt, batches, step):
            losses = []
            for j in range(self.m):
                devices = mesh.model_devices(j, self.m)
                if netplan is None:
                    w, s, loss = node_round(stacked_w[j], stacked_opt[j],
                                            batches[j], step)
                else:
                    with planner.plan_scope(netplan, devices) as sc:
                        w, s, loss = node_round(stacked_w[j],
                                                stacked_opt[j], batches[j],
                                                step)
                    if executed is not None and not executed:
                        executed.extend(sc.executed)
                stacked_w[j], stacked_opt[j] = w, s
                losses.append(loss)
            return stacked_w, stacked_opt, losses

        return round_fn

    def _place_node_batches(self, batches, mesh) -> list:
        """Node j's slice of the stacked numpy batches on node j's device
        (its stripe is split over the model devices inside the step)."""
        return [self._to_device({k: v[j] for k, v in batches.items()},
                                mesh.node_device(j, self.m))
                for j in range(self.m)]

    def _eval(self, params):
        # accuracy evals read the card by design (the scalar feeds Eq.
        # 7/10 weighting), and eval_fns are caller-supplied host code —
        # the whole call is a sanctioned scope under the sync sanitizer
        if not self.eval_fn:
            return 0.0
        with sanctioned_scope("eval"):
            return float(self.eval_fn(params))

    @staticmethod
    def _node_slice(stacked, node: int):
        """Node ``j``'s view of a node-stacked tree."""
        return tree_map(lambda x: x[node], stacked)

    def _eval_nodes(self, stacked) -> list:
        """Per-node accuracies for a node-stacked tree (or a node-sharded
        stack: a list of node trees), node by node."""
        trees = stacked if isinstance(stacked, list) else \
            [self._node_slice(stacked, j) for j in range(self.m)]
        return [max(self._eval(tree), 1e-3) for tree in trees]

    # ------------------------------------------------------------------
    def run(self, rounds: int,
            hooks: Optional[TrainHooks] = None) -> Iterator[RoundEvent]:
        """Stream the outer layer: one ``RoundEvent`` per merge.

        Resolves the execution engine (``engine.resolve_engine``), then
        yields each merge event — round index, per-node losses, virtual
        clock, cumulative sync-wait and comm-bytes, and the post-merge
        global weights.  Callers evaluate / checkpoint / early-stop at
        will; breaking out of the iterator stops training.

        ``hooks`` layers cadences on the stream: accuracy evals every
        ``eval_every`` events (0 keeps the engine's default),
        ``checkpoint_every`` saves ``event.params`` into
        ``checkpoint_dir`` via ``repro_torch.checkpointing`` — plus, for
        resumable engines, a ``kind="state"`` checkpoint carrying the
        engine snapshot, parameter-server log, IDPA allocation state and
        host RNG state — and ``on_round`` observes every event before it
        is yielded.  ``hooks.resume=True`` restores the latest state
        checkpoint before the first event, so a killed run relaunched
        with the same config continues losslessly (and a first launch
        with ``resume=True`` simply starts from scratch).

        A generator: config errors raise at the first ``next()``.
        """
        hooks = hooks or TrainHooks()
        # the devices resolve_engine counts: the trainer's pool when one
        # was given, else the CUDA devices (its default) when the params
        # are on the card, one CPU device when on the CPU
        devices = self.devices
        if devices is None and self.device.type != "cuda":
            devices = [self.device]
        plan = resolve_engine(self.tc, devices)
        self.last_plan = plan
        engine = plan.engine_cls(self, plan)
        self.last_engine = engine
        eval_every = hooks.eval_every or engine.default_eval_every
        state = engine.setup(rounds)
        start = 0
        if hooks.resume and hooks.checkpoint_dir:
            start = self._restore_run(engine, state, hooks.checkpoint_dir)
        for ev in engine.events(rounds, start=start, state=state):
            n = ev.round + 1
            if self.eval_fn and n % eval_every == 0:
                ev.accuracy = self._eval(ev.params)
            if hooks.checkpoint_every and hooks.checkpoint_dir \
                    and n % hooks.checkpoint_every == 0:
                checkpoint.save(hooks.checkpoint_dir, ev.params, step=n)
                self._save_run_state(engine, state, hooks.checkpoint_dir, n)
            if hooks.on_round:
                hooks.on_round(ev)
            yield ev

    def _save_run_state(self, engine, state, ckpt_dir: str, n: int) -> None:
        """Write the resumable train state (``kind="state"``) at event n."""
        snap = engine.snapshot(state)
        if snap is None:
            return                       # engine is not resumable
        arrays, scalars = snap
        scalars["trainer"] = {
            "next_event": n,
            "rng": self.rng.bit_generator.state,
            "dataset": self.dataset.state_dict(),
            "q_ema": self._q_ema,
        }
        checkpoint.save_state(ckpt_dir, arrays, n, scalars)

    def _restore_run(self, engine, state, ckpt_dir: str) -> int:
        """Restore the latest state checkpoint into ``state``; returns the
        event index to resume from (0 when no state checkpoint exists)."""
        step = checkpoint.latest_step(ckpt_dir, kind="state")
        if step is None:
            return 0
        snap = engine.snapshot(state)
        if snap is None:
            raise ValueError(
                f"{type(engine).__name__} does not support resumption but "
                f"{ckpt_dir} holds a state checkpoint")
        arrays_like, _ = snap
        arrays, scalars, _ = checkpoint.restore_state(
            ckpt_dir, arrays_like, step)
        engine.restore_snapshot(state, arrays, scalars)
        tr = scalars["trainer"]
        self.rng.bit_generator.state = tr["rng"]
        self.dataset.load_state_dict(tr["dataset"])
        self._q_ema = tr["q_ema"]
        return int(tr["next_event"])

    def train(self, rounds: int,
              hooks: Optional[TrainHooks] = None) -> TrainReport:
        """Drain ``run`` into a ``TrainReport``."""
        losses, accs = [], []
        last = None
        for ev in self.run(rounds, hooks):
            losses.append(ev.loss)
            if ev.accuracy is not None:
                accs.append((ev.virtual_clock, ev.accuracy))
            last = ev
        plan = self.last_plan
        return TrainReport(
            plan.strategy, len(losses), losses, accs,
            last.virtual_clock if last else 0.0,
            last.sync_wait if last else 0.0,
            last.comm_bytes if last else 0,
            self.dataset.totals,
            last.params if last is not None else self.params0,
            backend=plan.backend, fallback=plan.fallback,
            last_event=last.round + 1 if last is not None else 0)
