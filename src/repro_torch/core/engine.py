"""The outer layer's single-device execution engines for the BPT training
loop, from ``repro/core/engine.py``.

The paper's outer layer is ONE algorithm — pull the global weights, run
``local_steps`` local iterations per node, merge under Eq. 7 (SGWU) or
Eq. 9-10 (AGWU) — with interchangeable execution substrates:

| engine              | backend        | substrate                                |
|---------------------|----------------|------------------------------------------|
| ``ScanEngine``      | ``scan``       | sync baseline: one node round per round  |
| ``SequentialEngine``| ``sequential`` | per-node loop through the server (SGWU)  |
| ``VmapEngine``      | ``vmap``       | node-stacked params, Eq. 7 on the stack  |
| ``HeapEngine``      | ``heap``       | AGWU event-ordered heap, host server     |

The reference's ``device`` (``ShardMapEngine``) and ``heap-device``
(``HeapDeviceEngine``) substrates place each node on its own device; they
are not ported yet (``ROADMAP.md`` §1 item 5).  ``VmapEngine`` keeps the
reference's node-stacked structure without ``torch.func.vmap``: the
port's step takes gradients with ``torch.autograd`` and its kernels read
``data_ptr()``, neither of which works under a functorch transform, so
the m node rounds run as a loop over node slices of the stack.

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

from repro_torch.core.gwu import broadcast_tree
from repro_torch.core.param_server import ParameterServer
from repro_torch.core.tree import tree_map
from repro_torch.core.types import TrainConfig
from repro_torch.sanitize import sanctioned_sync, sanitized

__all__ = [
    "RoundEvent", "TrainHooks", "EnginePlan", "OuterEngine",
    "ScanEngine", "SequentialEngine", "VmapEngine", "HeapEngine",
    "ENGINES", "engine_config", "resolve_engine",
]

_MULTI_DEVICE = ("ROADMAP.md §1 item 5 (multi-device and planning: "
                 "ShardMapEngine, HeapDeviceEngine and the meshes)")


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
    backend: str               # scan|sequential|vmap|heap
    strategy: str              # sync|sgwu|agwu
    requested: str             # backend the config asked for
    fallback: str = ""         # "" unless backend != requested


def _default_devices() -> list:
    """The CUDA devices when PyTorch sees a card, else one CPU device."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def resolve_engine(cfg: TrainConfig, devices: Optional[Sequence] = None
                   ) -> EnginePlan:
    """Map a TrainConfig (+ available devices) to an execution plan.

    The only place in the port that inspects the ``fused_outer`` /
    ``device_outer`` / ``mesh_name`` combinations.  ``devices`` defaults
    to ``_default_devices()``; ``BPTTrainer`` passes the devices of its
    params' kind.  Every rule:

    - ``sync``: always ``ScanEngine``.
    - ``sgwu`` + ``device_outer``: with fewer devices than ``outer_nodes``,
      falls back to ``VmapEngine`` with the reason recorded in
      ``EnginePlan.fallback``; with enough devices, or a ``mesh_name``,
      raises ``NotImplementedError`` (``ShardMapEngine`` and the meshes
      are not ported).
    - ``sgwu`` + ``fused_outer``: ``VmapEngine``.
    - ``sgwu`` sequential: ``SequentialEngine``; rejects
      ``uneven_batches`` (only stacked rounds realize masked stripes).
    - ``agwu``: ``HeapEngine``, recording a fallback when
      ``device_outer`` asks for more devices than exist and raising
      ``NotImplementedError`` when enough exist (``HeapDeviceEngine``);
      rejects ``uneven_batches``.
    """
    if devices is None:
        devices = _default_devices()
    m = cfg.outer_nodes
    device_outer = cfg.device_outer  # reprolint: disable=RPL101
    if cfg.outer_strategy == "sgwu":
        if device_outer:
            if cfg.mesh_name:  # reprolint: disable=RPL101
                raise NotImplementedError(
                    f"mesh_name={cfg.mesh_name!r} needs the "  # reprolint: disable=RPL101
                    f"named meshes: {_MULTI_DEVICE}")
            if len(devices) >= m:
                raise NotImplementedError(
                    f"device_outer with {m} nodes on {len(devices)} "
                    f"devices needs ShardMapEngine: {_MULTI_DEVICE}")
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
                raise NotImplementedError(
                    f"device_outer with {m} nodes on {len(devices)} "
                    f"devices needs HeapDeviceEngine: {_MULTI_DEVICE}")
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
    """The stacked SGWU round loop (the reference shares it between its
    fused-vmap and device-sharded engines), so the Eq. 7/8 bookkeeping
    lives exactly once.

    Per-node virtual durations are an equal share of the measured round
    wall scaled by the node speed factors — the heterogeneity emulation
    the sequential loop derives from per-node measurement.
    """
    strategy = "sgwu"

    def _build(self):
        """-> (server, stacked_opt)"""
        raise NotImplementedError

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
        batches = t._to_device(batches)      # one explicit placement
        # the Eq. 8 wall starts AFTER the host batch draw + device
        # placement: data prep is the main server's work, not node compute,
        # and must not pollute the sync-wait or the IDPA duration feedback
        t0 = time.perf_counter()
        stacked_w, st.stacked_opt, node_losses = t._stacked_round(
            stacked_w, st.stacked_opt, batches, r)
        # the Eq. 8 measurement boundary: the host read waits for the
        # device, so the wall covers the round's device work — a
        # sanctioned sync, not a hidden one
        node_losses = sanctioned_sync(node_losses, "round.losses")
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
    ships the node's full local weights to the host-side server, which
    applies Eq. 10.

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

    def __init__(self, trainer, plan):
        super().__init__(trainer, plan)
        self.default_eval_every = trainer.m     # one eval per virtual round

    def total_events(self, rounds):
        return rounds * self.t.m

    def setup(self, rounds):
        t = self.t
        server = ParameterServer(t.params0, t.m)
        st = _HeapState(server, [t.opt.init(t.params0) for _ in range(t.m)],
                        [], {}, np.zeros(t.m, np.int64), np.ones(t.m),
                        rounds, slow=np.ones(t.m),
                        epoch=np.zeros(t.m, np.int64))
        for j in range(t.m):
            st.local[j], _ = server.pull(j)
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
                    st.local[e.node], _ = st.server.pull(e.node)
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
        st.server.push_agwu(j, w2, t._q_effective(q), virtual_time=st.clock)
        st.rounds_done[j] += 1
        alive = np.array([jj not in st.down for jj in range(t.m)])
        if alive.any() and \
                int(st.rounds_done[alive].min()) >= \
                t.dataset.part.current_batch:
            t.dataset.report_durations(
                st.node_durs * t.dataset.totals / max(t.batch_size, 1),
                active=alive if st.down else None)
        if st.rounds_done[j] < st.rounds:
            st.local[j], _ = st.server.pull(j)
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
                st.local[j], _ = st.server.pull(j)
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
            "base": {str(j): st.server._base[j] for j in range(t.m)},
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
            st.local[j] = self._place(arrays["local"][str(j)])
            st.opt_states[j] = self._place(arrays["opt"][str(j)])
            st.server._base[j] = self._place(arrays["base"][str(j)])
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


# ----------------------------------------------------------------------
# engine selection by name (drivers / benchmarks)
# ----------------------------------------------------------------------
ENGINES = {
    "scan": ScanEngine,
    "sequential": SequentialEngine,
    "vmap": VmapEngine,
    "heap": HeapEngine,
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
    (a ``device`` request on one device runs — and records — ``vmap``).
    """
    if name not in _ENGINE_CONFIGS:
        raise ValueError(
            f"unknown engine {name!r}: choose one of {sorted(_ENGINE_CONFIGS)}")
    return {**_ENGINE_CONFIGS[name], **overrides}
