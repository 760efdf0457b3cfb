"""Versioned parameter server for BPT-CNN's outer layer, from
``repro/core/param_server.py``.

Holds the global weight set, tracks versions, base snapshots per worker and
which versions are in flight — everything Eq. (9)-(10) needs.  Communication
accounting implements Eq. (11): every round trip is 2 transfers of the
weight-set payload.

The weights stay on the device they were given; the server's own state
(versions, base versions, bytes, the update log) is host bookkeeping.  A
worker's base is the global tree it pulled, held by reference, which is
safe because ``gwu`` builds every new global tree out of place.

With ``mesh=`` (a ``launch.mesh.Mesh`` with a ``nodes`` axis) the server
is device-resident: the node-stacked replicas are a list of m trees,
node j's on its mesh device, and the SGWU merge is Eq. 7 across those
devices (``gwu.sgwu_merge_and_rebroadcast_sharded``), summed on the
global weights' device.  Versions and Eq. 11 comm bytes are the same in
both modes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

from repro_torch.core.gwu import (agwu_gamma, agwu_update, agwu_update_delta,
                                  broadcast_tree, sgwu_merge,
                                  sgwu_merge_and_rebroadcast,
                                  sgwu_merge_and_rebroadcast_sharded)
from repro_torch.core.tree import tree_leaves
from repro_torch.launch.mesh import place, place_copy

__all__ = ["ParameterServer", "Submission"]


def _tree_bytes(tree) -> int:
    return int(sum(x.numel() * x.element_size() for x in tree_leaves(tree)))


@dataclasses.dataclass
class Submission:
    worker: int
    base_version: int
    accuracy: float
    virtual_time: float = 0.0


class ParameterServer:
    """Global weight store with SGWU and AGWU update paths."""

    def __init__(self, init_weights, num_workers: int, mesh=None):
        # ``mesh`` switches on DEVICE-RESIDENT mode: node j's replica lives
        # on its mesh device (on a 2-D (nodes, model) mesh, on the first
        # device of its row), and the SGWU merge sums the nodes' weights
        # on the global weights' device and copies the result back
        self.mesh = mesh
        if mesh is not None:
            if "nodes" not in mesh.axis_names:
                raise ValueError("device-resident mode needs a `nodes` axis")
            if num_workers % mesh.shape["nodes"] != 0:
                raise ValueError(
                    f"{num_workers} workers do not divide the `nodes` "
                    f"axis ({mesh.shape['nodes']})")
        self.global_weights = init_weights
        self.version = 0
        self.num_workers = num_workers
        # snapshots of the global weights each worker last pulled (W^(k))
        self._base: dict[int, Any] = {}
        self._base_version: dict[int, int] = {}
        self.weight_bytes = _tree_bytes(init_weights)
        self.comm_bytes = 0          # Eq. (11) accounting
        self.num_updates = 0
        self.update_log: list[Submission] = []
        # node-stacked replica cache for the stacked outer layer: the SGWU
        # merge rebroadcasts, so the next round's pull is free.  Ownership
        # moves to the caller on pull (the caller writes its nodes' results
        # into it), hence the hand-off-and-clear below.
        self._stacked: Any = None
        self._stacked_version = -1

    # ------------------------------------------------------------------
    def pull(self, worker: int):
        """Worker fetches the latest global weights (1 transfer)."""
        self._stacked = None    # mixed-API use: don't pin m replica copies
        self._base[worker] = self.global_weights
        self._base_version[worker] = self.version
        self.comm_bytes += self.weight_bytes
        return self.global_weights, self.version

    def pull_all_stacked(self, active=None):
        """All m workers pull at once: one node-stacked replica tree.

        Bookkeeping is identical to m individual ``pull`` calls (m
        transfers, every worker's base version advanced to the current
        version); the payload is a single tree whose leaves carry a
        leading node axis, one buffer per node.  Ownership of the stack
        transfers to the caller; a fresh pull re-broadcasts from the
        global weights only when no cached stack is available.

        ``active`` (per-worker bools) marks failed nodes: they do not
        pull, so they are not charged a transfer and their base version
        stays where it was — Eq. 11 counts only traffic that happened.
        """
        if self._stacked is not None and self._stacked_version == self.version:
            stacked, self._stacked = self._stacked, None
        elif self.mesh is not None:       # node j's replica on its device
            self._stacked = None
            stacked = [place_copy(self.global_weights,
                                  self.mesh.node_device(j, self.num_workers))
                       for j in range(self.num_workers)]
        else:
            self._stacked = None
            stacked = broadcast_tree(self.global_weights, self.num_workers)
        pulls = 0
        for j in range(self.num_workers):
            if active is not None and not active[j]:
                continue
            self._base[j] = self.global_weights
            self._base_version[j] = self.version
            pulls += 1
        self.comm_bytes += pulls * self.weight_bytes
        return stacked, self.version

    def outstanding_versions(self, exclude: Optional[int] = None):
        return [v for w, v in self._base_version.items() if w != exclude]

    # ------------------------------------------------------------------
    def warmup_agwu(self):
        """Nothing to compile ahead in eager PyTorch; kept so the API
        matches the reference's."""

    def push_agwu(self, worker: int, local_weights, accuracy: float,
                  virtual_time: float = 0.0):
        """AGWU: apply Eq. (10) immediately (1 transfer in).

        The reference's ``donate=`` hand-over of the local weights' buffers
        has no counterpart: eager PyTorch frees them once the caller drops
        them.
        """
        if worker not in self._base:
            raise RuntimeError(f"worker {worker} never pulled weights")
        base_w = self._base[worker]
        k = self._base_version[worker]
        gamma = agwu_gamma(k, max(self.version, 1),
                           self.outstanding_versions(exclude=worker))
        self._stacked = None    # any AGWU push stales the replica cache
        self.global_weights = agwu_update(
            self.global_weights, local_weights, base_w, gamma, accuracy)
        self.version += 1
        self.num_updates += 1
        self.comm_bytes += self.weight_bytes
        self.update_log.append(Submission(worker, k, accuracy, virtual_time))
        return gamma

    def push_agwu_delta(self, worker: int, delta, accuracy: float,
                        virtual_time: float = 0.0):
        """AGWU push of a delta W_j(k) - W(k) (1 transfer in): the same
        math as ``push_agwu`` split at the subtraction, with identical
        version/comm-bytes bookkeeping.  The delta moves to the global
        weights' device first."""
        if worker not in self._base:
            raise RuntimeError(f"worker {worker} never pulled weights")
        k = self._base_version[worker]
        gamma = agwu_gamma(k, max(self.version, 1),
                           self.outstanding_versions(exclude=worker))
        leaves = tree_leaves(self.global_weights)
        if leaves:              # the physical push: to the server's device
            delta = place(delta, leaves[0].device)
        self._stacked = None    # any AGWU push stales the replica cache
        self.global_weights = agwu_update_delta(
            self.global_weights, delta, gamma, accuracy)
        self.version += 1
        self.num_updates += 1
        self.comm_bytes += self.weight_bytes
        self.update_log.append(Submission(worker, k, accuracy, virtual_time))
        return gamma

    def push_sgwu(self, submissions: list[tuple[int, Any, float]],
                  virtual_time: float = 0.0):
        """SGWU: barrier-merge all workers' weights with Eq. (7).

        A submission whose weights are ``None`` marks a node that MISSED
        the barrier (failed mid-round): it enters the merge as the current
        global weights with weight 0 — mathematically excluded — and,
        because its push never arrived, adds no communication volume.
        """
        if len(submissions) != self.num_workers:
            raise RuntimeError("SGWU requires a submission from every worker")
        locals_, accs = [], []
        for worker, w, q in submissions:
            if w is None:                # missed the barrier: no transfer
                locals_.append(self.global_weights)
                accs.append(0.0)
                self.update_log.append(
                    Submission(worker, self.version, 0.0, virtual_time))
                continue
            locals_.append(w)
            accs.append(q)
            self.comm_bytes += self.weight_bytes
            self.update_log.append(
                Submission(worker, self.version, q, virtual_time))
        self._stacked = None    # list-path push stales the replica cache
        self.global_weights = sgwu_merge(locals_, accs)
        self.version += 1
        self.num_updates += 1
        return self.global_weights

    def push_sgwu_stacked(self, stacked_weights,
                          accuracies: Sequence[float],
                          virtual_time: float = 0.0, active=None):
        """SGWU barrier merge against the node-stacked representation.

        ``stacked_weights`` is ONE tree with a leading node axis of size
        m (worker j's weights at index j); the merge rebroadcasts into a
        new stack that the next ``pull_all_stacked`` hands out, so callers
        need not keep it.  In mesh mode it is the list of m node trees,
        and the merge writes the result into them (the caller hands them
        over).  Bookkeeping matches m individual submissions.
        ``active`` marks nodes that missed the barrier (failed mid-round):
        they must arrive with accuracy 0 (Eq. 7 excludes them) and are not
        charged a transfer — their push never happened.
        """
        if len(accuracies) != self.num_workers:
            raise RuntimeError("SGWU requires a submission from every worker")
        for worker, q in enumerate(accuracies):
            if active is not None and not active[worker]:
                if float(q) != 0.0:
                    raise ValueError(
                        f"node {worker} missed the barrier but carries "
                        f"merge weight {q!r} — dead nodes must merge at 0")
                self.update_log.append(
                    Submission(worker, self.version, 0.0, virtual_time))
                continue
            self.comm_bytes += self.weight_bytes
            self.update_log.append(
                Submission(worker, self.version, float(q), virtual_time))
        if self.mesh is not None:
            leaves = tree_leaves(self.global_weights)
            self.global_weights, self._stacked = \
                sgwu_merge_and_rebroadcast_sharded(
                    stacked_weights, accuracies, self.mesh,
                    device=leaves[0].device if leaves else None)
        else:
            self.global_weights, self._stacked = sgwu_merge_and_rebroadcast(
                stacked_weights, accuracies)
        self.version += 1
        self.num_updates += 1
        self._stacked_version = self.version
        return self.global_weights

    # ------------------------------------------------------------------
    def expected_comm_bytes(self, iterations: int) -> int:
        """Eq. (11): C = 2 c_w * m * K."""
        return 2 * self.weight_bytes * self.num_workers * iterations

    # ------------------------------------------------------------------
    # the host-side bookkeeping (version counters, per-worker base
    # versions, the Eq. 9-11 accounting and the full version log) as a
    # JSON-able dict, in the reference's format.  The weight payloads
    # themselves are not part of it.
    def state_dict(self) -> dict:
        return {
            "version": self.version,
            "num_updates": self.num_updates,
            "comm_bytes": self.comm_bytes,
            "base_version": {str(w): v
                             for w, v in self._base_version.items()},
            "update_log": [[s.worker, s.base_version, s.accuracy,
                            s.virtual_time] for s in self.update_log],
        }

    def load_state_dict(self, state: dict) -> None:
        self.version = int(state["version"])
        self.num_updates = int(state["num_updates"])
        self.comm_bytes = int(state["comm_bytes"])
        self._base_version = {int(w): int(v)
                              for w, v in state["base_version"].items()}
        self.update_log = [Submission(int(w), int(bv), float(q), float(vt))
                           for w, bv, q, vt in state["update_log"]]
        self._stacked = None
        self._stacked_version = -1
