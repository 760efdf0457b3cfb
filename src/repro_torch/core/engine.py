"""The outer layer's execution engines for the BPT training loop, from
``repro/core/engine.py``.

The paper's outer layer is ONE algorithm — pull the global weights, run
``local_steps`` local iterations per node, merge under Eq. 7 (SGWU) or
Eq. 9-10 (AGWU) — with interchangeable execution substrates:

| engine              | backend        | substrate                                |
|---------------------|----------------|------------------------------------------|
| ``ScanEngine``      | ``scan``       | sync baseline: one node round per round  |
| ``SequentialEngine``| ``sequential`` | per-node loop through the server (SGWU)  |
| ``VmapEngine``      | ``vmap``       | node-stacked params, Eq. 7 on the stack  |
| ``ShardMapEngine``  | ``device``     | node j on mesh device j; a 2-D ``(nodes, |
|                     |                | model)`` mesh runs the planner's plan    |
| ``HeapEngine``      | ``heap``       | AGWU event-ordered heap, server weights  |
| ``HeapDeviceEngine``| ``heap-device``| AGWU heap, node-pinned weights + deltas  |

``VmapEngine`` keeps the reference's node-stacked structure without
``torch.func.vmap``: the port's step takes gradients with
``torch.autograd`` and its kernels read ``data_ptr()``, neither of which
works under a functorch transform, so the m node rounds run as a loop
over node slices of the stack.  The mesh engines are one controller
driving a pool of devices, as the reference's ``shard_map`` is: a
node-sharded stack is a list of m trees, node j's on its mesh device,
and the Eq. 7 merge sums them on the server's device
(``gwu.sgwu_merge_and_rebroadcast_sharded``).  The pool is explicit
(``BPTTrainer(devices=...)``; ``launch.mesh``): the same device may
repeat, so four ``cuda:0`` run the sharded path on one card.

``resolve_engine(TrainConfig) -> EnginePlan`` is the single point that
inspects the ``fused_outer`` / ``device_outer`` / ``mesh_name`` flags, with
the reference's rules and messages.

Engines stream: ``events(rounds)`` yields one ``RoundEvent`` per merge —
per round for SGWU/sync, per push for AGWU — carrying the per-node losses,
the virtual clock, the cumulative Eq. 8 sync-wait and Eq. 11 comm-bytes,
and the post-merge global weights.  ``BPTTrainer.run`` layers the eval,
checkpoint and callback cadences (``TrainHooks``) on top.  Every engine
snapshots its state in the reference's trees and scalar keys, so a state
checkpoint written by either package resumes in the other.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import planner
from repro_torch.core.gwu import broadcast_tree, tree_sub
from repro_torch.core.param_server import ParameterServer
from repro_torch.core.tree import tree_map
from repro_torch.core.types import TrainConfig
from repro_torch.launch.mesh import (default_devices, make_mesh,
                                     make_nodes_mesh, place, place_copy)
from repro_torch.sanitize import sanctioned_sync, sanitized

__all__ = [
    "RoundEvent", "TrainHooks", "EnginePlan", "OuterEngine",
    "ScanEngine", "SequentialEngine", "VmapEngine", "ShardMapEngine",
    "HeapEngine", "HeapDeviceEngine", "ENGINES", "engine_config",
    "resolve_engine",
]


# ----------------------------------------------------------------------
# streaming surface
# ----------------------------------------------------------------------
@dataclasses.dataclass
class RoundEvent:
    """One outer-layer merge, as seen by a streaming caller.

    SGWU/sync engines emit one event per round; AGWU engines emit one per
    push (``node`` says which node pushed).  ``params`` is the global
    weight set AFTER this event's merge — callers may evaluate it or
    early-stop on ``loss``, or checkpoint it via
    ``repro_torch.checkpointing``.
    """
    round: int                 # event index (SGWU: round; AGWU: push count)
    node_losses: np.ndarray    # losses this event (AGWU: the pushing node's)
    loss: float                # mean of node_losses — the TrainReport entry
    virtual_clock: float       # emulated cluster time (Eq. 8 bookkeeping)
    sync_wait: float           # cumulative synchronization waiting (Eq. 8)
    comm_bytes: int            # cumulative communication volume (Eq. 11)
    params: Any                # global weights after the merge
    node: int = -1             # AGWU: pushing node (-1 for barrier engines)
    accuracy: Optional[float] = None   # filled at the TrainHooks cadence
    # measured per-node durations this event fed to IDPA (the Alg. 3.1
    # feedback signal — hooks observe exactly what the partitioner sees)
    durations: Optional[np.ndarray] = None
    # per-node membership at this event: 0.0 = failed, else the node's
    # current slowdown factor (1.0 = nominal) — FaultSchedule.status_at
    node_status: Optional[np.ndarray] = None


@dataclasses.dataclass
class TrainHooks:
    """Caller-owned cadences for the streaming loop.

    ``eval_every=0`` keeps each engine's historical default: every round
    for SGWU, every 5 rounds for the sync baseline, every m pushes for
    AGWU.  ``checkpoint_every`` saves ``event.params`` through
    ``repro_torch.checkpointing.checkpoint.save`` into ``checkpoint_dir``
    and, for resumable engines, a ``kind="state"`` train-state checkpoint
    (engine snapshot + parameter-server log + IDPA state + RNG state).
    ``resume=True`` restores the latest train-state checkpoint from
    ``checkpoint_dir`` before the first round — a killed run relaunched
    with the same hooks continues losslessly.
    """
    on_round: Optional[Callable[[RoundEvent], None]] = None
    eval_every: int = 0            # events between accuracy evals (0=default)
    checkpoint_every: int = 0      # events between checkpoints (0=off)
    checkpoint_dir: str = ""
    resume: bool = False           # restore latest state ckpt before round 1


# ----------------------------------------------------------------------
# the single config-resolution point
# ----------------------------------------------------------------------
@dataclasses.dataclass
class EnginePlan:
    """Resolved execution plan: which engine runs, and why.

    ``backend`` is the substrate that will actually execute; ``requested``
    is what the flags asked for.  When they differ, ``fallback`` carries
    the human-readable reason (too few devices) and is surfaced on
    ``TrainReport.fallback``.
    """
    engine_cls: type
    backend: str               # scan|sequential|vmap|device|heap|heap-device
    strategy: str              # sync|sgwu|agwu
    requested: str             # backend the config asked for
    mesh: Any = None           # the `nodes` mesh (ShardMapEngine only)
    fallback: str = ""         # "" unless backend != requested
    devices: Any = None        # the device pool the plan was resolved
                               # against (HeapDeviceEngine pins node j to
                               # devices[j]; ShardMapEngine via ``mesh``)


def _nodes_mesh(cfg: TrainConfig, m: int, devices):
    """The `nodes` mesh for the device-sharded outer layer, or None when
    the pool has too few devices (the transparent fallback).  A
    ``mesh_name`` whose `nodes` axis mismatches ``outer_nodes`` is a
    config bug, not a capacity problem, and raises.  2-D hybrid meshes
    (``nodesNxmodelK``) pass: only the ``nodes`` axis is validated here;
    the ``model`` axis is the planner's."""
    name = cfg.mesh_name  # reprolint: disable=RPL101
    try:
        mesh = make_mesh(name, devices=devices) if name \
            else make_nodes_mesh(m, devices=devices)
    except RuntimeError:
        return None
    if "nodes" not in mesh.axis_names or mesh.shape["nodes"] != m:
        raise ValueError(
            f"mesh {name!r} needs a `nodes` axis of size "
            f"{m}, has axes {dict(mesh.shape)}")
    return mesh


def resolve_engine(cfg: TrainConfig, devices: Optional[Sequence] = None
                   ) -> EnginePlan:
    """Map a TrainConfig (+ available devices) to an execution plan.

    The only place in the port that inspects the ``fused_outer`` /
    ``device_outer`` / ``mesh_name`` combinations.  ``devices`` (the pool,
    a list of ``torch.device``) defaults to ``launch.mesh.
    default_devices()`` (the distinct CUDA devices, or one CPU device);
    ``BPTTrainer`` passes its ``devices=`` or the devices of its params'
    kind.  Every rule:

    - ``sync``: always ``ScanEngine``; rejects ``uneven_batches``.
    - ``sgwu`` + ``device_outer``: ``ShardMapEngine`` on the ``mesh_name``
      mesh (or an auto 1-D `nodes` mesh); a 2-D ``nodesNxmodelK`` mesh
      turns on the per-layer inner planner (``core.planner``); a mesh
      without a matching `nodes` axis raises; too few devices falls back
      to ``VmapEngine`` with the reason recorded in
      ``EnginePlan.fallback``.
    - ``sgwu`` + ``fused_outer``: ``VmapEngine``.
    - ``sgwu`` sequential: ``SequentialEngine``; rejects
      ``uneven_batches`` (only stacked rounds realize masked stripes).
    - ``agwu``: ``HeapDeviceEngine`` when ``device_outer`` and >= m
      devices exist (node-pinned weights, Eq. 10 delta pushes), else
      ``HeapEngine`` (fallback recorded); rejects ``uneven_batches``.
    """
    if devices is None:
        devices = default_devices()
    m = cfg.outer_nodes
    device_outer = cfg.device_outer  # reprolint: disable=RPL101
    if cfg.outer_strategy == "sgwu":
        if device_outer:
            mesh = _nodes_mesh(cfg, m, devices)
            if mesh is not None:
                return EnginePlan(ShardMapEngine, "device", "sgwu",
                                  "device", mesh=mesh)
            return EnginePlan(
                VmapEngine, "vmap", "sgwu", "device",
                fallback=f"device_outer needs {m} devices, have "
                f"{len(devices)}: running the fused vmap emulation")
        if cfg.fused_outer:  # reprolint: disable=RPL101
            return EnginePlan(VmapEngine, "vmap", "sgwu", "vmap")
        if cfg.uneven_batches:
            raise ValueError(
                "uneven_batches needs the fused or device outer path")
        return EnginePlan(SequentialEngine, "sequential", "sgwu",
                          "sequential")
    if cfg.uneven_batches:
        # only the stacked-round SGWU paths realize the padded+masked
        # stripes; silently training with uniform batches would fake
        # the heterogeneity the flag promises
        raise ValueError(
            "uneven_batches needs outer_strategy='sgwu' (the fused or "
            f"device outer path), not {cfg.outer_strategy!r}")
    if cfg.outer_strategy == "agwu":
        if device_outer:
            if len(devices) >= m:
                return EnginePlan(HeapDeviceEngine, "heap-device", "agwu",
                                  "heap-device", devices=list(devices))
            return EnginePlan(
                HeapEngine, "heap", "agwu", "heap-device",
                fallback=f"device_outer needs {m} devices, have "
                f"{len(devices)}: running the host-heap AGWU path")
        return EnginePlan(HeapEngine, "heap", "agwu", "heap")
    return EnginePlan(ScanEngine, "scan", "sync", "scan")


# ----------------------------------------------------------------------
# engines
# ----------------------------------------------------------------------
class OuterEngine:
    """One execution substrate for the outer layer.

    Protocol: ``setup(rounds) -> state`` builds the parameter server and
    optimizer state; ``run_round(state, r) -> RoundEvent`` executes one
    merge event; ``events(rounds)`` drives the two as a generator.
    Engines never read TrainConfig substrate flags — ``resolve_engine``
    already decided everything and recorded it in the ``EnginePlan`` they
    are constructed with.

    Crash-safe resumption: ``snapshot(state) -> (arrays, scalars)``
    captures everything ``setup`` and the rounds so far produced — a tree
    of weight and optimizer tensors plus a JSON-able scalar dict (server
    version log, clocks, heap entries).  ``restore_snapshot(state,
    arrays, scalars)`` rebuilds a fresh ``setup`` state in place, after
    which ``events(rounds, start=n, state=state)`` continues from event
    ``n`` exactly where the killed run stopped.  Engines that return
    ``None`` from ``snapshot`` are not resumable (no state checkpoint is
    written for them).
    """
    backend = ""
    strategy = ""

    def __init__(self, trainer, plan: EnginePlan):
        self.t = trainer
        self.plan = plan
        # historical eval cadence (events between accuracy measurements);
        # TrainHooks.eval_every overrides
        self.default_eval_every = 1

    def total_events(self, rounds: int) -> int:
        return rounds

    def setup(self, rounds: int):
        raise NotImplementedError

    def run_round(self, state, r: int) -> RoundEvent:
        raise NotImplementedError

    def events(self, rounds: int, start: int = 0,
               state: Any = None) -> Iterator[RoundEvent]:
        state = self.setup(rounds) if state is None else state
        for r in range(start, self.total_events(rounds)):
            # the round body runs under the sync sanitizer
            # (REPRO_SANITIZE=1): a hidden host sync raises; the event is
            # yielded OUTSIDE the scope so consumers (eval / checkpoint
            # hooks) may read freely
            with sanitized(f"{self.backend}.run_round"):
                ev = self.run_round(state, r)
            yield ev

    def snapshot(self, state):
        """``(arrays, scalars)`` capturing the resumable train state, or
        ``None`` for engines that do not support resumption."""
        return None

    def restore_snapshot(self, state, arrays, scalars) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} does not support resumption")

    def _place(self, tree):
        """A restored tree on the trainer's device, placed explicitly (the
        reference commits its numpy trees with ``device_put``)."""
        device = self.t.device
        return tree_map(lambda x: x.to(device), tree)

    # -- fault-schedule access ------------------------------------------
    @property
    def faults(self):
        """The trainer's FaultSchedule, or None when churn-free."""
        f = self.t.faults
        return None if (f is None or f.empty) else f


# -------------------------- sync baseline ---------------------------
@dataclasses.dataclass
class _ScanState:
    params: Any
    opt_state: Any
    clock: float = 0.0


class ScanEngine(OuterEngine):
    """Synchronous single-node data parallelism (one node round a round)."""
    backend = "scan"
    strategy = "sync"

    def __init__(self, trainer, plan):
        super().__init__(trainer, plan)
        self.default_eval_every = 5

    def setup(self, rounds):
        t = self.t
        if self.faults is not None:
            raise ValueError(
                "the sync baseline has no outer-layer membership to churn; "
                "fault schedules need outer_strategy='sgwu' or 'agwu'")
        return _ScanState(t.params0, t.opt.init(t.params0))

    def snapshot(self, st):
        arrays = {"params": st.params, "opt": st.opt_state}
        return arrays, {"clock": st.clock}

    def restore_snapshot(self, st, arrays, scalars):
        st.params = self._place(arrays["params"])
        st.opt_state = self._place(arrays["opt"])
        st.clock = float(scalars["clock"])

    def run_round(self, st, r):
        t = self.t
        batches = [t.dataset.node_batch(0, t.batch_size, t.rng)
                   for _ in range(t.tc.local_steps)]
        # stack on host, then ONE explicit placement
        stacked = t._to_device({k: np.stack([b[k] for b in batches])
                                for k in batches[0]})
        # same contract as the stacked engines: the clock starts after the
        # host batch draw, so the virtual time is compute-only
        t0 = time.perf_counter()
        st.params, st.opt_state, loss = t._node_round(
            st.params, st.opt_state, stacked, r)
        loss = float(sanctioned_sync(loss, "scan.loss"))
        st.clock += (time.perf_counter() - t0) * t.speed[0]
        return RoundEvent(round=r, node_losses=np.asarray([loss]),
                          loss=loss, virtual_clock=st.clock,
                          sync_wait=0.0, comm_bytes=0, params=st.params)


# ------------------------- stacked SGWU -----------------------------
@dataclasses.dataclass
class _StackedState:
    server: ParameterServer
    stacked_opt: Any
    clock: float = 0.0
    sync_wait: float = 0.0


class _StackedSGWUEngine(OuterEngine):
    """The stacked SGWU round loop shared by the fused-vmap and
    device-sharded engines — they differ only in the server mode, the
    round callable, the batch placement and the node stack's layout, so
    the Eq. 7/8 bookkeeping lives exactly once.

    Per-node virtual durations are an equal share of the measured round
    wall scaled by the node speed factors — the heterogeneity emulation
    the sequential loop derives from per-node measurement.
    """
    strategy = "sgwu"

    def _build(self):
        """-> (server, stacked_opt)"""
        raise NotImplementedError

    def _place_batches(self, batches):
        """The round's stacked numpy batches on the device(s)."""
        return self.t._to_device(batches)

    def _round(self, stacked_w, stacked_opt, batches, step):
        return self.t._stacked_round(stacked_w, stacked_opt, batches, step)

    def setup(self, rounds):
        return _StackedState(*self._build())

    def snapshot(self, st):
        arrays = {"global": st.server.global_weights, "opt": st.stacked_opt}
        scalars = {"clock": st.clock, "sync_wait": st.sync_wait,
                   "server": st.server.state_dict()}
        return arrays, scalars

    def restore_snapshot(self, st, arrays, scalars):
        st.server.global_weights = self._place(arrays["global"])
        # load_state_dict also drops the server's stacked-replica cache:
        # the next pull rebroadcasts the restored global weights
        st.server.load_state_dict(scalars["server"])
        st.stacked_opt = self._place(arrays["opt"])
        st.clock = float(scalars["clock"])
        st.sync_wait = float(scalars["sync_wait"])

    def run_round(self, st, r):
        t = self.t
        faults = self.faults
        status = faults.status_at(r, t.m) if faults else None
        alive = status > 0.0 if status is not None \
            else np.ones(t.m, dtype=bool)
        if not alive.any():
            raise RuntimeError(
                f"fault schedule leaves no node alive at round {r}")
        stacked_w, _ = st.server.pull_all_stacked(
            active=alive if faults else None)
        batches = t.dataset.stacked_round_batches(
            t.batch_size, t.tc.local_steps, t.rng,
            uneven=t.tc.uneven_batches)
        batches = self._place_batches(batches)   # one explicit placement
        # the Eq. 8 wall starts AFTER the host batch draw + device
        # placement: data prep is the main server's work, not node compute,
        # and must not pollute the sync-wait or the IDPA duration feedback
        t0 = time.perf_counter()
        stacked_w, st.stacked_opt, node_losses = self._round(
            stacked_w, st.stacked_opt, batches, r)
        # the Eq. 8 measurement boundary: the host read waits for the
        # device, so the wall covers the round's device work — a
        # sanctioned sync, not a hidden one
        node_losses = np.asarray(sanctioned_sync(node_losses,
                                                 "round.losses"))
        wall = time.perf_counter() - t0
        # a dead node's slice still computes, but its result never reaches
        # the barrier: its duration is 0 (no push to wait for), its merge
        # weight is 0, and it re-enters at the next round's rebroadcast pull
        durs = (wall / t.m) * t.speed
        if status is not None:
            durs = durs * status             # slow factors; dead lanes -> 0
        st.clock += float(durs[alive].max())
        st.sync_wait += float((durs[alive].max() - durs[alive]).sum())
        if t.eval_fn:
            qs = np.asarray(t._eval_nodes(stacked_w), dtype=np.float64)
        else:
            qs = np.ones(t.m)                # SGWU normalises in Eq. 7
        qs = np.where(alive, qs, 0.0)        # Eq. 7 excludes the dead
        st.server.push_sgwu_stacked(stacked_w, qs, virtual_time=st.clock,
                                    active=alive if faults else None)
        t.dataset.report_durations(durs,
                                   active=alive if faults else None)
        loss = float(node_losses[alive].mean())
        return RoundEvent(round=r, node_losses=node_losses, loss=loss,
                          virtual_clock=st.clock, sync_wait=st.sync_wait,
                          comm_bytes=st.server.comm_bytes,
                          params=st.server.global_weights,
                          durations=durs.copy(), node_status=status)


class VmapEngine(_StackedSGWUEngine):
    """The stacked outer layer on one device: node-stacked params and
    optimizer states flow ``pull_all_stacked`` -> ``BPTTrainer.
    _stacked_round`` (the m node rounds over slices of the stack) ->
    ``push_sgwu_stacked`` (the Eq. 7 merge on the stack and its
    rebroadcast)."""
    backend = "vmap"

    def _build(self):
        t = self.t
        server = ParameterServer(t.params0, t.m)
        stacked_opt = broadcast_tree(t.opt.init(t.params0), t.m)
        return server, stacked_opt


class ShardMapEngine(_StackedSGWUEngine):
    """Device-sharded outer layer: the paper's m physical nodes.

    The round structure of ``VmapEngine``, but node j's weights, optimizer
    state and batch live on mesh device j (``plan.mesh``), its round runs
    there (``BPTTrainer._get_device_round``), and the Eq. 7 merge in the
    device-resident ParameterServer moves each node's weights to the
    server's device, sums them in node order and copies the result back to
    every node.

    On a 2-D ``(nodes, model)`` mesh (the ``nodesNxmodelK`` family) the
    engine also plans per-layer inner parallelism:
    ``core.planner.plan_network`` gives the ``NetworkPlan`` each node's
    round executes over the node's model devices — ``self.netplan`` holds
    it and ``self.executed`` the LayerPlans the kernels' ops consumed.
    The reference records those once a trace; the port's ops take a plan
    at every eager forward, so ``executed`` holds the first node round's
    first forward only.  Weights and optimizer state stay one tree a
    node, on the node's first device.
    """
    backend = "device"
    netplan = None      # NetworkPlan (2-D meshes only)

    def __init__(self, trainer, plan):
        super().__init__(trainer, plan)
        self.executed = []   # LayerPlans consumed by the kernels' ops

    def _build(self):
        t, mesh = self.t, self.plan.mesh
        server = ParameterServer(t.params0, t.m, mesh=mesh)
        stacked_opt = self._node_trees(t.opt.init(t.params0))
        netplan = None
        if dict(mesh.shape).get("model", 1) > 1:
            netplan = planner.plan_network(
                t.model_cfg, mesh, batch_size=t.batch_size,
                family=t.plan_family)
            self.netplan = netplan
        self._round_fn = t._get_device_round(mesh, netplan, self.executed)
        return server, stacked_opt

    def _node_trees(self, tree, stacked=False):
        """m copies of ``tree`` (of its slice ``[j]`` for node j where
        ``stacked``), node j's in buffers of its own on its mesh device."""
        t, mesh = self.t, self.plan.mesh
        return [place_copy(tree_map(lambda x: x[j], tree) if stacked
                           else tree, mesh.node_device(j, t.m))
                for j in range(t.m)]

    def _place_batches(self, batches):
        return self.t._place_node_batches(batches, self.plan.mesh)

    def _round(self, stacked_w, stacked_opt, batches, step):
        return self._round_fn(stacked_w, stacked_opt, batches, step)

    def snapshot(self, st):
        # the reference's format: the optimizer states stacked on a
        # leading node axis, on the server's device
        device = self.t.device
        opt = tree_map(lambda *xs: torch.stack([x.to(device) for x in xs]),
                       *st.stacked_opt)
        arrays = {"global": st.server.global_weights, "opt": opt}
        scalars = {"clock": st.clock, "sync_wait": st.sync_wait,
                   "server": st.server.state_dict()}
        return arrays, scalars

    def restore_snapshot(self, st, arrays, scalars):
        # re-establish the device-resident layout: the global weights on
        # the server's device, node j's optimizer state on its device
        st.server.global_weights = self._place(arrays["global"])
        st.server.load_state_dict(scalars["server"])
        st.stacked_opt = self._node_trees(arrays["opt"], stacked=True)
        st.clock = float(scalars["clock"])
        st.sync_wait = float(scalars["sync_wait"])


# ------------------------ sequential SGWU ---------------------------
@dataclasses.dataclass
class _SequentialState:
    server: ParameterServer
    opt_states: list
    clock: float = 0.0
    sync_wait: float = 0.0


class SequentialEngine(OuterEngine):
    """Per-node emulation: one pull, ``local_steps`` steps and one
    submission per node.  The reference the stacked path is
    regression-tested against."""
    backend = "sequential"
    strategy = "sgwu"

    def setup(self, rounds):
        t = self.t
        return _SequentialState(ParameterServer(t.params0, t.m),
                                [t.opt.init(t.params0) for _ in range(t.m)])

    def snapshot(self, st):
        arrays = {"global": st.server.global_weights,
                  "opt": {str(j): s for j, s in enumerate(st.opt_states)}}
        scalars = {"clock": st.clock, "sync_wait": st.sync_wait,
                   "server": st.server.state_dict()}
        return arrays, scalars

    def restore_snapshot(self, st, arrays, scalars):
        st.server.global_weights = self._place(arrays["global"])
        st.server.load_state_dict(scalars["server"])
        st.opt_states = [self._place(arrays["opt"][str(j)])
                         for j in range(len(st.opt_states))]
        st.clock = float(scalars["clock"])
        st.sync_wait = float(scalars["sync_wait"])

    def run_round(self, st, r):
        t = self.t
        faults = self.faults
        status = faults.status_at(r, t.m) if faults else None
        alive = status > 0.0 if status is not None \
            else np.ones(t.m, dtype=bool)
        if not alive.any():
            raise RuntimeError(
                f"fault schedule leaves no node alive at round {r}")
        subs, durs = [], np.zeros(t.m)
        node_losses = np.zeros(t.m)
        for j in range(t.m):
            if not alive[j]:
                # a failed node never pulls, computes, or pushes: it
                # misses the barrier and Eq. 7 excludes it (weight 0)
                subs.append((j, None, 0.0))
                continue
            w, _ = st.server.pull(j)
            w2, st.opt_states[j], loss, dur = t._local_round(
                w, st.opt_states[j], j, r)
            q = t._eval(w2) if t.eval_fn else 1.0
            subs.append((j, w2, max(q, 1e-3)))  # SGWU normalises in Eq. 7
            durs[j] = dur * (status[j] if status is not None else 1.0)
            node_losses[j] = loss
        st.clock += float(durs[alive].max())
        st.sync_wait += float((durs[alive].max() - durs[alive]).sum())
        st.server.push_sgwu(subs, virtual_time=st.clock)
        t.dataset.report_durations(durs,
                                   active=alive if faults else None)
        return RoundEvent(round=r, node_losses=node_losses,
                          loss=float(node_losses[alive].mean()),
                          virtual_clock=st.clock, sync_wait=st.sync_wait,
                          comm_bytes=st.server.comm_bytes,
                          params=st.server.global_weights,
                          durations=durs.copy(), node_status=status)


# ----------------------------- AGWU ---------------------------------
@dataclasses.dataclass
class _HeapState:
    server: ParameterServer
    opt_states: list
    heap: list                     # (virtual_time, node, round, epoch)
    local: dict
    base_local: dict               # heap-device: node-resident W(k)
    rounds_done: np.ndarray
    node_durs: np.ndarray
    rounds: int
    clock: float = 0.0
    # --- node churn ---
    down: set = dataclasses.field(default_factory=set)
    slow: np.ndarray = None        # per-node duration multipliers
    epoch: np.ndarray = None       # bumped on fail: stales in-flight work
    fault_cursor: int = 0          # next unapplied FaultSchedule event


class HeapEngine(OuterEngine):
    """AGWU keeps its event-ordered heap (the ordering IS the algorithm).

    One ``RoundEvent`` per push: ``total_events`` is m x rounds.  A push
    ships the node's full local weights to the server, which applies
    Eq. 10 (``HeapDeviceEngine``: node-pinned weights, delta pushes).

    Node churn: fault-schedule transitions are keyed on the EVENT index
    (the i-th successful push) and applied before each heap pop.  A
    ``fail`` bumps the node's epoch — its in-flight heap entry becomes
    stale and is dropped at pop time (the push never arrives at the
    server, Eq. 10 never sees the lost work).  A ``rejoin`` re-pulls the
    current global weights and re-enters the heap at the current virtual
    clock with a FRESH base version, so its next gamma (Eq. 10) reflects
    the staleness it actually has.  A ``slow`` multiplies the node's
    measured durations, which flows straight into the IDPA feedback.
    """
    backend = "heap"
    strategy = "agwu"
    device_nodes = False

    def __init__(self, trainer, plan):
        super().__init__(trainer, plan)
        self.default_eval_every = trainer.m     # one eval per virtual round

    def total_events(self, rounds):
        return rounds * self.t.m

    def _pull(self, st, j):
        w, _ = st.server.pull(j)
        if self.device_nodes:
            w = place(w, self.plan.devices[j])
            st.base_local[j] = w       # W(k) snapshot, node-resident
        return w

    def setup(self, rounds):
        t = self.t
        server = ParameterServer(t.params0, t.m)
        st = _HeapState(server, [t.opt.init(t.params0) for _ in range(t.m)],
                        [], {}, {}, np.zeros(t.m, np.int64), np.ones(t.m),
                        rounds, slow=np.ones(t.m),
                        epoch=np.zeros(t.m, np.int64))
        for j in range(t.m):
            if self.device_nodes:
                st.opt_states[j] = place(st.opt_states[j],
                                         self.plan.devices[j])
            st.local[j] = self._pull(st, j)
            heapq.heappush(st.heap, (0.0, j, 0, 0))
        return st

    # ---------------- churn transitions ------------------------------
    def _apply_faults(self, st, i):
        faults = self.faults
        if faults is None:
            return
        evs = faults.events
        while st.fault_cursor < len(evs) and evs[st.fault_cursor].round <= i:
            e = evs[st.fault_cursor]
            st.fault_cursor += 1
            if e.kind == "fail":
                st.down.add(e.node)
                st.epoch[e.node] += 1       # in-flight work is lost
            elif e.kind == "rejoin":
                st.down.discard(e.node)
                if st.rounds_done[e.node] < st.rounds:
                    st.local[e.node] = self._pull(st, e.node)
                    heapq.heappush(
                        st.heap, (st.clock, e.node,
                                  int(st.rounds_done[e.node]),
                                  int(st.epoch[e.node])))
            else:                           # "slow"
                st.slow[e.node] = e.factor

    def _status(self, st):
        status = st.slow.copy()
        for j in st.down:
            status[j] = 0.0
        return status

    def _process(self, st, i) -> Optional[RoundEvent]:
        """Pop one heap entry; None = the push was lost to a failure."""
        t = self.t
        vt, j, r, epoch = heapq.heappop(st.heap)
        if j in st.down or epoch != int(st.epoch[j]):
            return None                     # stale push: node died mid-round
        w2, st.opt_states[j], loss, dur = t._local_round(
            st.local[j], st.opt_states[j], j, r)
        dur *= float(st.slow[j])
        st.node_durs[j] = dur
        st.clock = vt + dur
        q = t._eval(w2) if t.eval_fn else 1.0
        if self.device_nodes:
            delta = tree_sub(w2, st.base_local[j])   # on node j's device
            st.server.push_agwu_delta(j, delta, t._q_effective(q),
                                      virtual_time=st.clock)
        else:
            st.server.push_agwu(j, w2, t._q_effective(q),
                                virtual_time=st.clock)
        st.rounds_done[j] += 1
        alive = np.array([jj not in st.down for jj in range(t.m)])
        if alive.any() and \
                int(st.rounds_done[alive].min()) >= \
                t.dataset.part.current_batch:
            t.dataset.report_durations(
                st.node_durs * t.dataset.totals / max(t.batch_size, 1),
                active=alive if st.down else None)
        if st.rounds_done[j] < st.rounds:
            st.local[j] = self._pull(st, j)
            heapq.heappush(st.heap, (st.clock, j, int(st.rounds_done[j]),
                                     int(st.epoch[j])))
        return RoundEvent(round=i, node=j,
                          node_losses=np.asarray([loss]), loss=loss,
                          virtual_clock=st.clock, sync_wait=0.0,
                          comm_bytes=st.server.comm_bytes,
                          params=st.server.global_weights,
                          durations=st.node_durs.copy(),
                          node_status=self._status(st)
                          if self.faults else None)

    def run_round(self, st, i):
        ev = None
        while ev is None:
            ev = self._process(st, i)
        return ev

    def events(self, rounds, start=0, state=None):
        st = self.setup(rounds) if state is None else state
        # a restored snapshot of a COMPLETED shorter run holds an empty
        # heap (each node finished its configured rounds, so nothing was
        # re-pulled); extending ``rounds`` on resume re-seeds those nodes
        # at the current clock — the same transition as a rejoin.  Fresh
        # and mid-run states already carry current-epoch entries, so
        # this is a no-op for them.
        live = {(j, e) for _, j, _, e in st.heap}
        for j in range(self.t.m):
            if j in st.down or st.rounds_done[j] >= st.rounds:
                continue
            if (j, int(st.epoch[j])) not in live:
                st.local[j] = self._pull(st, j)
                heapq.heappush(st.heap, (st.clock, j,
                                         int(st.rounds_done[j]),
                                         int(st.epoch[j])))
        i = start
        budget = self.total_events(rounds)
        while i < budget:
            self._apply_faults(st, i)
            if not st.heap:
                # permanent failures: the dead nodes' rounds never run;
                # the surviving nodes have completed all of theirs
                return
            with sanitized(f"{self.backend}.push"):
                ev = self._process(st, i)
            if ev is None:
                continue                    # dropped (lost) push
            yield ev
            i += 1

    # ---------------- crash-safe snapshot ----------------------------
    def snapshot(self, st):
        t = self.t
        arrays = {
            "global": st.server.global_weights,
            "local": {str(j): st.local[j] for j in range(t.m)},
            "opt": {str(j): s for j, s in enumerate(st.opt_states)},
            "base": {str(j): (st.base_local[j] if self.device_nodes
                              else st.server._base[j])
                     for j in range(t.m)},
        }
        scalars = {
            "clock": st.clock,
            "heap": [[vt, j, r, e] for vt, j, r, e in st.heap],
            "rounds_done": st.rounds_done.tolist(),
            "node_durs": st.node_durs.tolist(),
            "down": sorted(st.down),
            "slow": st.slow.tolist(),
            "epoch": st.epoch.tolist(),
            "fault_cursor": st.fault_cursor,
            "server": st.server.state_dict(),
        }
        return arrays, scalars

    def restore_snapshot(self, st, arrays, scalars):
        t = self.t
        st.server.global_weights = self._place(arrays["global"])
        st.server.load_state_dict(scalars["server"])
        for j in range(t.m):
            local, opt = arrays["local"][str(j)], arrays["opt"][str(j)]
            base = arrays["base"][str(j)]
            if self.device_nodes:      # back onto node j's pinned device
                local, opt, base = (place(a, self.plan.devices[j])
                                    for a in (local, opt, base))
                st.base_local[j] = base
            else:
                local, opt, base = (self._place(a)
                                    for a in (local, opt, base))
                st.server._base[j] = base
            st.local[j] = local
            st.opt_states[j] = opt
        st.heap = [(float(vt), int(j), int(r), int(e))
                   for vt, j, r, e in scalars["heap"]]
        heapq.heapify(st.heap)
        st.rounds_done = np.asarray(scalars["rounds_done"], np.int64)
        st.node_durs = np.asarray(scalars["node_durs"], np.float64)
        st.down = set(scalars["down"])
        st.slow = np.asarray(scalars["slow"], np.float64)
        st.epoch = np.asarray(scalars["epoch"], np.int64)
        st.fault_cursor = int(scalars["fault_cursor"])
        st.clock = float(scalars["clock"])


class HeapDeviceEngine(HeapEngine):
    """AGWU with each node's weights and optimizer state pinned to its own
    device (``plan.devices[j]``); a push computes the Eq. 10 delta
    W_j(k) - W(k) on the node's device and ships ONLY the delta to the
    server (``push_agwu_delta``)."""
    backend = "heap-device"
    device_nodes = True


# ----------------------------------------------------------------------
# engine selection by name (drivers / benchmarks)
# ----------------------------------------------------------------------
ENGINES = {
    "scan": ScanEngine,
    "sequential": SequentialEngine,
    "vmap": VmapEngine,
    "device": ShardMapEngine,
    "heap": HeapEngine,
    "heap-device": HeapDeviceEngine,
}

_ENGINE_CONFIGS = {
    "scan": dict(outer_strategy="sync"),
    "sequential": dict(outer_strategy="sgwu", fused_outer=False,
                       device_outer=False),
    "vmap": dict(outer_strategy="sgwu", fused_outer=True,
                 device_outer=False),
    "device": dict(outer_strategy="sgwu", device_outer=True),
    "heap": dict(outer_strategy="agwu", device_outer=False),
    "heap-device": dict(outer_strategy="agwu", device_outer=True),
}


def engine_config(name: str, **overrides) -> dict:
    """TrainConfig kwargs that ``resolve_engine`` maps to the named engine.

    Drivers select substrates by name (``--engine vmap``) instead of
    setting flag combinations by hand; device-count fallbacks still apply
    (a ``device`` request on a small pool runs — and records — ``vmap``).
    """
    if name not in _ENGINE_CONFIGS:
        raise ValueError(
            f"unknown engine {name!r}: choose one of {sorted(_ENGINE_CONFIGS)}")
    return {**_ENGINE_CONFIGS[name], **overrides}
