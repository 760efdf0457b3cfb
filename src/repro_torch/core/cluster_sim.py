"""Event-driven heterogeneous-cluster simulator for BPT-CNN's outer layer,
from ``repro/core/cluster_sim.py`` (numpy, the port's IDPA partitioners
and its ``ParameterServer``).

Reproduces the paper's distributed experiments (Figs. 12-15) on a single
host: each virtual computing node has a per-sample processing time; a
virtual clock advances in completion-time order.  The *weight math is real*
(an optional ``worker_train`` callback runs actual training on the node's
IDPA-assigned subset); only wall-clock time is virtual.  Weights are trees
of tensors: ``worker_train`` receives the server's global weights on the
device ``init_weights`` lives on and returns a tree on that device.

Metrics produced:
  * total virtual makespan
  * synchronization waiting time  (Eq. 8, SGWU)
  * communication bytes           (Eq. 11 accounting via ParameterServer)
  * workload balance degree       (Fig. 15b)
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.idpa import (IDPAPartitioner, UDPAPartitioner,
                                   workload_balance_degree)
from repro_torch.core.param_server import ParameterServer

__all__ = ["ClusterSim", "SimResult", "make_heterogeneous_speeds"]


def make_heterogeneous_speeds(m: int, spread: float = 0.5,
                              seed: int = 0) -> np.ndarray:
    """Per-sample times for m nodes, uniform in [1-spread/2, 1+spread/2]."""
    rng = np.random.default_rng(seed)
    return 1.0 + spread * (rng.random(m) - 0.5)


# worker_train(worker_id, weights, sample_indices, iteration)
#   -> (new_weights, accuracy)
WorkerTrainFn = Callable[[int, object, np.ndarray, int], tuple]


def _placeholder():
    """The weight set of a callback-free simulation: one f32 (its 4 bytes
    drive the Eq. 11 accounting, as in the reference)."""
    return {"w": torch.zeros(1, dtype=torch.float32)}


@dataclasses.dataclass
class SimResult:
    strategy: str
    partitioning: str
    num_nodes: int
    iterations: int
    makespan: float                 # total virtual time
    sync_wait: float                # Eq. (8) (0 for AGWU by construction)
    comm_bytes: int                 # measured, == Eq. (11) for both
    expected_comm_bytes: int        # Eq. (11) closed form
    balance_degree: float           # Fig. 15(b) metric (min/max node busy time)
    allocation: np.ndarray          # samples per node
    final_weights: object = None
    accuracy_trace: list = dataclasses.field(default_factory=list)

    def summary(self) -> dict:
        return {
            "strategy": self.strategy,
            "partitioning": self.partitioning,
            "m": self.num_nodes,
            "K": self.iterations,
            "makespan": round(self.makespan, 4),
            "sync_wait": round(self.sync_wait, 4),
            "comm_MB": round(self.comm_bytes / 2**20, 4),
            "balance": round(self.balance_degree, 4),
        }


class ClusterSim:
    """Simulate BPT-CNN outer-layer training on m heterogeneous nodes.

    Parameters
    ----------
    per_sample_time : virtual seconds one node needs per training sample
        (heterogeneity profile; the paper's 1/mu_j up to measurement noise).
    strategy : 'sgwu' | 'agwu'
    partitioning : 'idpa' | 'udpa'
    duration_source : 'model' rolls virtual durations from the per-sample
        heterogeneity profile (+ optional noise) — the explicit simulation
        mode; 'measured' feeds IDPA the *measured* wall time of each
        ``worker_train`` call (requires one), the production feedback path.
    fault_schedule : optional ``core.faults.FaultSchedule`` — node churn.
        SGWU applies transitions at the start of the named iteration; AGWU
        before processing the named push (see the faults module docstring).
    """

    def __init__(self,
                 num_samples: int,
                 per_sample_time: Sequence[float],
                 iterations: int,
                 batches: int,
                 strategy: str = "agwu",
                 partitioning: str = "idpa",
                 noise: float = 0.0,
                 seed: int = 0,
                 idpa_mode: str = "paper",
                 duration_source: str = "model",
                 fault_schedule=None):
        self.N = int(num_samples)
        self.t = np.asarray(per_sample_time, dtype=np.float64)
        self.m = len(self.t)
        self.K = int(iterations)
        self.A = int(batches)
        if strategy not in ("sgwu", "agwu"):
            raise ValueError(strategy)
        if partitioning not in ("idpa", "udpa"):
            raise ValueError(partitioning)
        if duration_source not in ("model", "measured"):
            raise ValueError(
                f"duration_source={duration_source!r}: 'model' or 'measured'")
        self.strategy = strategy
        self.partitioning = partitioning
        self.duration_source = duration_source
        self.noise = noise
        self.rng = np.random.default_rng(seed)
        self.faults = fault_schedule if fault_schedule is not None \
            and not fault_schedule.empty else None
        if self.faults is not None:
            self.faults.validate_nodes(self.m)

        if partitioning == "idpa":
            # nominal frequency = inverse per-sample time (the paper's mu_j)
            self.part = IDPAPartitioner(self.N, self.m, self.A,
                                        frequencies=1.0 / self.t,
                                        mode=idpa_mode)
        else:
            self.part = UDPAPartitioner(self.N, self.m, self.A)

    # ------------------------------------------------------------------
    def _duration(self, node: int, nsamples: int) -> float:
        base = self.t[node] * nsamples
        if self.noise:
            base *= 1.0 + self.noise * (self.rng.random() - 0.5)
        return max(base, 1e-9)

    def _allocate(self, durations: Optional[np.ndarray],
                  active: Optional[np.ndarray] = None) -> np.ndarray:
        """Advance the partitioner one batch; returns cumulative totals."""
        if self.part.current_batch == 0:
            self.part.first_batch(active=active)
        elif not self.part.done:
            if isinstance(self.part, IDPAPartitioner):
                self.part.next_batch(durations, active=active)
            else:
                self.part.next_batch(None, active=active)
        return self.part.totals.copy()

    # ------------------------------------------------------------------
    def run(self,
            init_weights=None,
            worker_train: Optional[WorkerTrainFn] = None,
            eval_fn: Optional[Callable] = None) -> SimResult:
        if self.duration_source == "measured" and worker_train is None:
            raise ValueError(
                "duration_source='measured' needs a worker_train callback "
                "to measure — use 'model' for callback-free simulation")
        if self.strategy == "sgwu":
            return self._run_sgwu(init_weights, worker_train, eval_fn)
        return self._run_agwu(init_weights, worker_train, eval_fn)

    # ---------------------------- SGWU --------------------------------
    def _run_sgwu(self, init_weights, worker_train, eval_fn) -> SimResult:
        server = ParameterServer(init_weights if init_weights is not None
                                 else _placeholder(), self.m)
        clock = 0.0
        sync_wait = 0.0
        busy = np.zeros(self.m)
        totals = None
        durations = None
        acc_trace = []

        for it in range(self.K):
            status = self.faults.status_at(it, self.m) if self.faults \
                else None
            alive = status > 0.0 if status is not None \
                else np.ones(self.m, dtype=bool)
            if not alive.any():
                raise RuntimeError(
                    f"fault schedule leaves no node alive at iteration {it}")
            if not self.part.done or totals is None:
                # a just-rejoined node has no measurement from the previous
                # iteration (its duration slot is 0) — it sits this batch
                # out and earns work once it reports a real duration
                active = None
                if self.faults:
                    active = alive.copy()
                    if durations is not None:
                        active &= durations > 0.0
                totals = self._allocate(durations, active=active)

            durations = np.zeros(self.m)
            subs = []
            for j in range(self.m):
                if not alive[j]:
                    # dead: no pull, no compute, missed the barrier —
                    # Eq. 7 excludes it (weight 0, no transfer charged)
                    subs.append((j, None, 0.0))
                    continue
                d = self._duration(j, int(totals[j])) \
                    if self.duration_source == "model" else 0.0
                w, _ = server.pull(j)
                if worker_train is not None:
                    idx = self._indices(j, totals)
                    t0 = time.perf_counter()
                    new_w, q = worker_train(j, w, idx, it)
                    if self.duration_source == "measured":
                        d = max(time.perf_counter() - t0, 1e-9)
                else:
                    new_w, q = w, 1.0
                if status is not None:
                    d *= status[j]          # slow-node factor
                durations[j] = d
                subs.append((j, new_w, q))
            busy += durations
            t_max = float(durations[alive].max())
            sync_wait += float((t_max - durations[alive]).sum())  # Eq. (8)
            clock += t_max
            server.push_sgwu(subs, virtual_time=clock)
            if eval_fn is not None:
                acc_trace.append((clock, eval_fn(server.global_weights)))

        return self._result(server, clock, sync_wait, busy, totals, acc_trace)

    # ---------------------------- AGWU --------------------------------
    def _run_agwu(self, init_weights, worker_train, eval_fn) -> SimResult:
        server = ParameterServer(init_weights if init_weights is not None
                                 else _placeholder(), self.m)
        busy = np.zeros(self.m)
        iters_done = np.zeros(self.m, dtype=np.int64)
        acc_trace = []
        measured = self.duration_source == "measured"

        # churn bookkeeping: a fail bumps the node's epoch, staling its
        # in-flight heap entry (the push is dropped at pop time — lost)
        down: set[int] = set()
        slow = np.ones(self.m)
        epoch = np.zeros(self.m, dtype=np.int64)
        fault_events = self.faults.events if self.faults else ()
        cursor = 0

        totals = self._allocate(None)
        # priority queue of (completion_time, node, epoch-at-schedule)
        heap: list[tuple[float, int, int]] = []
        clock = 0.0
        local_w = {}
        # per-node pending (weights, accuracy): in measured mode the work
        # RUNS at schedule time (its wall time IS the charged duration)
        # and lands on the server when its completion event pops
        pending: dict[int, tuple] = {}
        # the durations the simulation actually charged each node (most
        # recent work unit) — the IDPA feedback signal, Alg. 3.1's
        # measured t_j.  Re-rolling fresh noisy durations here would
        # consume extra RNG and decouple allocation from observed load.
        charged = np.zeros(self.m)

        def schedule(j: int, at: float):
            w, _ = server.pull(j)
            it = int(iters_done[j])
            if measured:
                idx = self._indices(j, totals)
                t0 = time.perf_counter()
                pending[j] = worker_train(j, w, idx, it)
                d = max(time.perf_counter() - t0, 1e-9)
            else:
                local_w[j] = w
                d = self._duration(j, int(totals[j]))
            d *= float(slow[j])
            charged[j] = d
            busy[j] += d
            heapq.heappush(heap, (at + d, j, int(epoch[j])))

        for j in range(self.m):
            schedule(j, 0.0)

        i = 0                                    # successful-push index
        while heap:
            # fault transitions keyed on the push index, applied before
            # the pop — "fail at 5" drops everything in flight from the
            # 5th merge event onward
            while cursor < len(fault_events) and \
                    fault_events[cursor].round <= i:
                e = fault_events[cursor]
                cursor += 1
                if e.kind == "fail":
                    down.add(e.node)
                    epoch[e.node] += 1           # in-flight work is lost
                elif e.kind == "rejoin":
                    down.discard(e.node)
                    if iters_done[e.node] < self.K:
                        schedule(e.node, clock)
                else:
                    slow[e.node] = e.factor
            if not heap:
                break
            t_done, j, ep = heapq.heappop(heap)
            if j in down or ep != int(epoch[j]):
                continue                         # lost push: died mid-round
            clock = t_done
            it = int(iters_done[j])
            if measured:
                new_w, q = pending.pop(j)
            elif worker_train is not None:
                idx = self._indices(j, totals)
                new_w, q = worker_train(j, local_w[j], idx, it)
            else:
                new_w, q = local_w[j], 1.0
            server.push_agwu(j, new_w, q, virtual_time=clock)
            if eval_fn is not None:
                acc_trace.append((clock, eval_fn(server.global_weights)))
            iters_done[j] += 1
            i += 1

            # incremental allocation: advance once every LIVE node finished
            # iteration `a` (the paper allocates per global batch round),
            # feeding IDPA the durations the simulation charged; dead nodes
            # neither gate the batch nor receive any of it
            alive = np.array([jj not in down for jj in range(self.m)])
            if not self.part.done and alive.any() and \
                    int(iters_done[alive].min()) >= self.part.current_batch:
                totals = self._allocate(charged.copy(),
                                        active=alive if down else None)

            if iters_done[j] < self.K:
                schedule(j, t_done)

        return self._result(server, clock, 0.0, busy, totals, acc_trace)

    # ------------------------------------------------------------------
    def _indices(self, j: int, totals: np.ndarray) -> np.ndarray:
        """Stable per-node sample ranges: node j owns a contiguous stripe."""
        starts = np.concatenate([[0], np.cumsum(totals)[:-1]])
        return np.arange(starts[j], starts[j] + totals[j]) % max(self.N, 1)

    def _result(self, server, clock, sync_wait, busy, totals,
                acc_trace) -> SimResult:
        return SimResult(
            strategy=self.strategy,
            partitioning=self.partitioning,
            num_nodes=self.m,
            iterations=self.K,
            makespan=float(clock),
            sync_wait=float(sync_wait),
            comm_bytes=int(server.comm_bytes),
            expected_comm_bytes=server.expected_comm_bytes(self.K),
            balance_degree=workload_balance_degree(busy),
            allocation=totals,
            final_weights=server.global_weights,
            accuracy_trace=acc_trace,
        )
