"""Data pipeline: sequence packing, sharded host loading, IDPA partitioning.

A copy of ``repro/data/pipeline.py`` (numpy only; batches stay numpy, and
the trainer places them on its device).

``IDPADataset`` glues the paper's partitioner (core/idpa.py) to an actual
dataset: each virtual computing node (data-parallel group) owns the sample
stripe the partitioner assigned it, re-partitioned incrementally as measured
throughputs arrive — the production analogue of Alg. 3.1 where the "main
server" is the input pipeline.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.idpa import IDPAPartitioner, UDPAPartitioner

__all__ = ["pack_sequences", "IDPADataset", "host_batch"]


def pack_sequences(corpus: np.ndarray, seq_len: int) -> np.ndarray:
    """Pack a token stream into (N, seq_len+1) rows (inputs+shifted labels)."""
    if seq_len < 1:
        raise ValueError(f"seq_len must be >= 1, got {seq_len}")
    if len(corpus) < seq_len + 1:
        raise ValueError(
            f"corpus of {len(corpus)} tokens is too short to pack even one "
            f"row: need at least seq_len + 1 = {seq_len + 1} tokens")
    n = (len(corpus) - 1) // seq_len
    rows = np.stack([corpus[i * seq_len:(i + 1) * seq_len + 1]
                     for i in range(n)])
    return rows.astype(np.int32)


def host_batch(rows: np.ndarray):
    """(B, S+1) rows -> {'tokens': (B,S), 'labels': (B,S)}."""
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


class IDPADataset:
    """Per-node dataset views driven by the IDPA/UDPA partitioner.

    Usage:
        ds = IDPADataset(data_arrays, num_nodes=4, batches=4,
                         frequencies=[...])
        for epoch_round in range(...):
            views = ds.node_views()          # list of per-node index arrays
            ...train...
            ds.report_durations(durations)   # feeds Alg. 3.1
    """

    def __init__(self, arrays: dict, num_nodes: int, batches: int,
                 frequencies: Optional[Sequence[float]] = None,
                 partitioning: str = "idpa", idpa_mode: str = "paper"):
        self.arrays = arrays
        self.n = len(next(iter(arrays.values())))
        if partitioning == "idpa":
            if frequencies is None:
                frequencies = np.ones(num_nodes)
            self.part = IDPAPartitioner(self.n, num_nodes, batches,
                                        frequencies=frequencies,
                                        mode=idpa_mode)
        else:
            self.part = UDPAPartitioner(self.n, num_nodes, batches)
        self.part.first_batch()

    @property
    def totals(self) -> np.ndarray:
        return self.part.totals

    def report_durations(self, durations, active=None) -> bool:
        """Feed measured per-node durations; returns True if re-allocated.

        ``active`` masks failed nodes out of the next allocation batch
        (node churn): a dead node keeps its existing stripe but receives
        nothing new until it rejoins.
        """
        if self.part.done:
            return False
        if isinstance(self.part, IDPAPartitioner):
            self.part.next_batch(durations, active=active)
        else:
            self.part.next_batch(None, active=active)
        return True

    # -- crash-safe checkpointing: the partitioner's incremental state ---
    def state_dict(self) -> dict:
        return self.part.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.part.load_state_dict(state)

    def node_views(self) -> list[np.ndarray]:
        """Contiguous index stripes per node (no migration — paper §3.3.1)."""
        totals = self.part.totals
        starts = np.concatenate([[0], np.cumsum(totals)[:-1]])
        return [np.arange(starts[j], starts[j] + totals[j]) % self.n
                for j in range(len(totals))]

    @staticmethod
    def _select(view: np.ndarray, node: int, batch_size: int,
                rng: np.random.Generator) -> np.ndarray:
        """Sample indices from one node's stripe — the ONE sampling rule
        both the sequential and the stacked batch paths share, so their
        numerical equivalence holds by construction."""
        take = min(batch_size, len(view))
        if take == 0:
            raise ValueError(f"node {node} has no samples allocated yet")
        return rng.choice(view, size=batch_size, replace=take < batch_size)

    def node_batch(self, node: int, batch_size: int, rng: np.random.Generator):
        sel = self._select(self.node_views()[node], node, batch_size, rng)
        return {k: v[sel] for k, v in self.arrays.items()}

    @property
    def num_nodes(self) -> int:
        return self.part.num_nodes

    def node_round_batch_sizes(self, batch_size: int) -> np.ndarray:
        """Per-node effective batch sizes ∝ the current IDPA allocation.

        The fastest node (largest stripe) trains on the full
        ``batch_size``; slower nodes get proportionally smaller effective
        loads — the heterogeneity-aware workload the partitioner encodes,
        carried into each round's compute.
        """
        totals = np.maximum(self.totals, 1).astype(np.float64)
        sizes = np.ceil(batch_size * totals / totals.max()).astype(np.int64)
        return np.clip(sizes, 1, batch_size)

    def stacked_round_batches(self, batch_size: int, local_steps: int,
                              rng: np.random.Generator, *,
                              uneven: bool = False):
        """One SGWU round's data for ALL nodes: ``(m, local_steps, B, ...)``.

        Draws node-by-node, step-by-step — the exact RNG consumption
        order of the sequential per-node loop's ``node_batch`` calls — so
        the fused vmapped round sees bit-identical batches and stays
        numerically equivalent to the legacy path on a fixed seed.  The
        index stripes are built once for the round (the allocation only
        changes between rounds, via ``report_durations``).

        With ``uneven=True`` each node draws only its
        ``node_round_batch_sizes`` share and the stripe is padded back to
        ``batch_size`` (cycling the drawn samples) with a float ``mask``
        leaf of shape ``(m, local_steps, B)`` marking the real rows — the
        static-shape realization of IDPA's per-node loads that the
        fused/device-sharded round needs (the loss must honour
        ``batch["mask"]``).
        """
        m = self.num_nodes
        views = self.node_views()
        sizes = self.node_round_batch_sizes(batch_size) if uneven \
            else np.full(m, batch_size, np.int64)
        mask = np.zeros((m, local_steps, batch_size), np.float32)
        sels = []
        for j in range(m):
            node = []
            for s in range(local_steps):
                sel = self._select(views[j], j, int(sizes[j]), rng)
                if len(sel) < batch_size:      # pad by cycling; masked out
                    sel = np.resize(sel, batch_size)
                node.append(sel)
                mask[j, s, :sizes[j]] = 1.0
            sels.append(node)
        out = {k: np.stack([np.stack([v[sel] for sel in node])
                            for node in sels])
               for k, v in self.arrays.items()}
        if uneven:
            out["mask"] = mask
        return out
