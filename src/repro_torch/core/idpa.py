"""Incremental Data Partitioning and Allocation (IDPA) — Algorithm 3.1.

A copy of ``repro/core/idpa.py`` (numpy only; the port imports nothing
of the reference).

Faithful implementation of the paper's heterogeneity-aware partitioner
(Eq. 2-6) plus the UDPA baseline used in Fig. 14.

The partitioner is pure Python/NumPy state machine: it consumes *measured*
per-node iteration durations and emits the per-node sample counts for each
allocation batch.  The same object drives (a) the event-driven cluster
simulator, (b) the real BPT trainer (where "nodes" are data-parallel mesh
groups and durations are measured step times), and (c) the dry-run batch
sharding rules.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "IDPAPartitioner",
    "UDPAPartitioner",
    "effective_iterations",
    "workload_balance_degree",
]


def effective_iterations(K: int, A: int) -> int:
    """Eq. (6): remaining iterations after incremental allocation.

    Total K' = A + floor((N*K - N(A+1)/2) / N) = K + A/2 - 1 (paper's Eq. 6,
    integer arithmetic with the floor kept explicit).
    """
    if A < 1:
        raise ValueError("A must be >= 1")
    if A >= K:
        raise ValueError("paper requires A < K (fewer batches than iterations)")
    delta_k = (2 * K - (A + 1)) // 2  # floor(K - (A+1)/2)
    return A + delta_k


def workload_balance_degree(loads: Sequence[float]) -> float:
    """Workload balance metric used for Fig. 15(b): min/max load ratio.

    1.0 = perfectly balanced.  Empty or all-zero loads => 1.0 by convention.
    """
    arr = np.asarray(loads, dtype=np.float64)
    if arr.size == 0 or float(arr.max()) == 0.0:
        return 1.0
    return float(arr.min() / arr.max())


@dataclasses.dataclass
class _BaseAllocator:
    """Shared bookkeeping for IDPA/UDPA."""

    num_samples: int          # N
    num_nodes: int            # m
    num_batches: int          # A

    def __post_init__(self) -> None:
        if self.num_nodes < 1:
            raise ValueError("need at least one computing node")
        if self.num_batches < 1:
            raise ValueError("need at least one allocation batch")
        if self.num_samples < self.num_nodes:
            raise ValueError("need at least one sample per node")
        # cumulative totals n_j = sum_a n_j^(a)
        self.totals = np.zeros(self.num_nodes, dtype=np.int64)
        self.history: list[np.ndarray] = []   # per-batch allocations
        self._batch = 0

    @property
    def batch_size(self) -> int:
        """floor(N/A): samples released per allocation batch."""
        return self.num_samples // self.num_batches

    @property
    def current_batch(self) -> int:
        return self._batch

    @property
    def done(self) -> bool:
        return self._batch >= self.num_batches

    def _record(self, alloc: np.ndarray) -> np.ndarray:
        alloc = alloc.astype(np.int64)
        self.totals += alloc
        self.history.append(alloc)
        self._batch += 1
        return alloc

    def _active_mask(self, active) -> np.ndarray:
        """Validate/default the churn mask: allocation only targets nodes
        the fault schedule reports alive.  Dead nodes keep what they were
        already allocated (§3.3.1: no migration) but the current batch is
        distributed entirely among the active nodes — the round is never
        starved."""
        if active is None:
            return np.ones(self.num_nodes, dtype=bool)
        mask = np.asarray(active, dtype=bool)
        if mask.shape != (self.num_nodes,):
            raise ValueError("need one active flag per node")
        if not mask.any():
            raise ValueError(
                "cannot allocate a batch with every node inactive")
        return mask

    # ------------------------------------------------------------------
    # crash-safe checkpointing: the partitioner is part of the resumable
    # training state (a resumed run must continue the SAME incremental
    # allocation, not restart it)
    def state_dict(self) -> dict:
        return {
            "totals": self.totals.tolist(),
            "history": [h.tolist() for h in self.history],
            "batch": self._batch,
        }

    def load_state_dict(self, state: dict) -> None:
        totals = np.asarray(state["totals"], dtype=np.int64)
        if totals.shape != (self.num_nodes,):
            raise ValueError(
                f"partitioner state has {totals.shape[0]} nodes, "
                f"expected {self.num_nodes}")
        self.totals = totals
        self.history = [np.asarray(h, dtype=np.int64)
                        for h in state["history"]]
        self._batch = int(state["batch"])


@dataclasses.dataclass
class IDPAPartitioner(_BaseAllocator):
    """Algorithm 3.1 — heterogeneity-aware incremental partitioner.

    Parameters
    ----------
    frequencies : nominal per-node compute power mu_j (CPU/GPU frequency in
        the paper; measured tokens/s for a TPU data-parallel group here).
    """

    frequencies: Sequence[float] = ()
    # "paper": verbatim Eq. (3)-(5) — T_a from the *arithmetic* mean t_bar,
    #   node m absorbs the remainder.  Faithful, but the arithmetic mean
    #   over-allocates the head nodes on strongly heterogeneous clusters.
    # "balanced": beyond-paper fix — pick the target duration so the batch's
    #   increments sum exactly to floor(N/A) (harmonic-mean form), which
    #   achieves the paper's *stated* objective (all nodes finish together).
    mode: str = "paper"

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.mode not in ("paper", "balanced"):
            raise ValueError(self.mode)
        freq = np.asarray(self.frequencies, dtype=np.float64)
        if freq.shape != (self.num_nodes,):
            raise ValueError("need one frequency per node")
        if np.any(freq <= 0):
            raise ValueError("frequencies must be positive")
        self.freq = freq
        # measured mean per-sample time t_bar_j (populated after batch 1)
        self.per_sample_time = np.zeros(self.num_nodes, dtype=np.float64)

    # ------------------------------------------------------------------
    def first_batch(self, active=None) -> np.ndarray:
        """Eq. (2): frequency-proportional split of the first batch.

        ``active`` masks nodes out of the allocation (node churn): the
        batch is split among the active nodes only.
        """
        if self._batch != 0:
            raise RuntimeError("first_batch() already consumed")
        mask = self._active_mask(active)
        b = self.batch_size
        freq = np.where(mask, self.freq, 0.0)
        alloc = np.floor(b * freq / freq.sum()).astype(np.int64)
        # the last active node takes the remainder (paper's j == m case)
        last = int(np.flatnonzero(mask)[-1])
        alloc[last] = b - int(alloc.sum() - alloc[last])
        return self._record(alloc)

    def next_batch(self, durations: Sequence[float],
                   active=None) -> np.ndarray:
        """Eq. (3)-(5): allocation from measured durations of the previous
        iteration.

        durations[j] = T_j, wall time node j took to process its *current
        total* sample count in the last iteration.  Churn extensions:

        * ``active`` masks failed nodes out of the batch entirely (their
          duration entries are ignored — a dead node reports nothing);
        * an active node may report ``inf`` (zero capacity): it receives
          zero new samples, and the batch is still fully distributed among
          the finite-capacity nodes — no starvation, no crash.
        """
        if self._batch == 0:
            raise RuntimeError("call first_batch() first")
        if self.done:
            raise RuntimeError("all batches already allocated")
        mask = self._active_mask(active)
        T = np.asarray(durations, dtype=np.float64)
        if T.shape != (self.num_nodes,):
            raise ValueError("need one duration per node")
        if np.any(T[mask] <= 0) or np.any(np.isnan(T[mask])):
            raise ValueError("durations must be positive")

        # t_bar_j = T_j / n_j  (paper normalises by the node's sample count)
        n_now = np.maximum(self.totals, 1)
        t_bar = np.where(mask, T / n_now, np.inf)
        # capacity carriers: active nodes with finite measured time.  An
        # active node at zero capacity (inf duration) stays in the run but
        # takes no new work this batch.
        carrier = mask & np.isfinite(t_bar)
        if not carrier.any():
            raise ValueError(
                "every active node reported infinite duration — no node "
                "can carry this allocation batch")
        self.per_sample_time = np.where(carrier, T / n_now,
                                        self.per_sample_time)
        t_mean = t_bar[carrier].mean()             # t_bar in Eq. (3)

        a = self._batch + 1                         # 1-indexed batch number
        b = self.batch_size
        if self.mode == "paper":
            # Eq. (3): predicted mean duration of iteration a (the node
            # count is the carriers' — the batch only lands on them)
            T_a = (b * a * t_mean) / int(carrier.sum())
        else:
            # balanced: duration such that sum_j T_a/t_j == b*a exactly
            T_a = (b * a) / float(np.sum(1.0 / t_bar[carrier]))
        # Eq. (4): target cumulative sample count so all nodes finish at T_a
        with np.errstate(invalid="ignore"):
            n_target = np.where(carrier, T_a / t_bar, 0.0)
        # Eq. (5): the increment this batch, floored at zero (a node that is
        # already over-subscribed takes no new samples rather than "negative"
        # samples; the paper implicitly assumes non-negative increments).
        inc = np.floor(n_target - self.totals).astype(np.int64)
        inc = np.maximum(inc, 0)
        inc[~carrier] = 0
        # the last capacity-carrying node absorbs the remainder so the
        # batch sums to floor(N/A)
        last = int(np.flatnonzero(carrier)[-1])
        head = int(inc.sum() - inc[last])
        if head > b:
            # rescale head nodes to fit the batch, preserving proportions
            scale = b / head
            inc = np.floor(inc * scale).astype(np.int64)
            inc[~carrier] = 0
            head = int(inc.sum() - inc[last])
        inc[last] = b - head
        return self._record(inc)

    def allocate_all(self, duration_fn) -> np.ndarray:
        """Drive all A batches; duration_fn(totals)->durations per node."""
        self.first_batch()
        while not self.done:
            self.next_batch(duration_fn(self.totals))
        return self.totals.copy()

    def state_dict(self) -> dict:
        state = super().state_dict()
        state["per_sample_time"] = self.per_sample_time.tolist()
        return state

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self.per_sample_time = np.asarray(state["per_sample_time"],
                                          dtype=np.float64)


@dataclasses.dataclass
class UDPAPartitioner(_BaseAllocator):
    """Uniform baseline of Fig. 14: equal split, all at once or per batch."""

    def first_batch(self, active=None) -> np.ndarray:
        return self.next_batch(None, active=active)

    def next_batch(self, _durations=None, active=None) -> np.ndarray:
        if self.done:
            raise RuntimeError("all batches already allocated")
        mask = self._active_mask(active)
        b = self.batch_size
        k = int(mask.sum())
        alloc = np.where(mask, b // k, 0).astype(np.int64)
        last = int(np.flatnonzero(mask)[-1])
        alloc[last] = b - int(alloc.sum() - alloc[last])
        return self._record(alloc)

    def allocate_all(self, duration_fn=None) -> np.ndarray:
        while not self.done:
            self.next_batch(None)
        return self.totals.copy()
