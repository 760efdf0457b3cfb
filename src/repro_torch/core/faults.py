"""Fault schedules for the elastic outer layer: node churn and slowdowns.

A copy of ``repro/core/faults.py`` (numpy only; the port imports nothing
of the reference).

The paper's AGWU/IDPA strategies exist to absorb heterogeneity and
stragglers (§3); a ``FaultSchedule`` makes that claim testable by injecting
membership changes mid-run.  A schedule is a sorted list of ``FaultEvent``s
keyed on an integer *event index* whose meaning depends on the consumer:

* barrier engines (sync / SGWU) and ``ClusterSim._run_sgwu`` apply events
  at the START of the named round,
* the AGWU heap engines and ``ClusterSim._run_agwu`` apply events before
  processing the named *push* (the same index ``RoundEvent.round`` carries
  for AGWU streams), so "fail at 5" means the node is dead from the 5th
  merge event onward.

Semantics per kind:

* ``fail``   — the node's in-flight work is LOST (its AGWU push simply
  never arrives on the event heap; its SGWU submission is excluded from
  the Eq. 7 merge with weight 0) and it stops computing.
* ``rejoin`` — the node re-pulls the current global weights and resumes.
  Because every SGWU pull rebroadcasts the merged weights, and an AGWU
  rejoin is an ordinary fresh pull, a rejoined node is in sync by
  construction — no special recovery path exists to get wrong.
* ``slow``   — the node's virtual durations are multiplied by ``factor``
  from that point on (1.0 restores nominal speed).  IDPA sees the slowdown
  through the measured-duration feedback and re-allocates.

Dead nodes keep the samples IDPA already allocated to them (§3.3.1: no
migration) but receive nothing from later allocation batches — the
partitioner is fed an ``active`` mask alongside the measured durations.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Iterable, Sequence

import numpy as np

__all__ = ["FaultEvent", "FaultSchedule"]

_KINDS = ("fail", "rejoin", "slow")


@dataclasses.dataclass(frozen=True, order=True)
class FaultEvent:
    """One membership/speed transition: ``kind`` applied to ``node`` at
    event index ``round`` (see module docstring for the per-engine index
    semantics).  ``factor`` is the slowdown multiplier for ``slow``."""
    round: int
    node: int
    kind: str
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"FaultEvent.kind={self.kind!r}: choose one of {_KINDS}")
        if self.round < 0 or self.node < 0:
            raise ValueError(
                f"FaultEvent round/node must be >= 0, got "
                f"({self.round}, {self.node})")
        if self.kind == "slow" and not self.factor > 0:
            raise ValueError(
                f"FaultEvent.factor={self.factor}: slowdown must be > 0")


# one CLI/spec atom: kind:node@round[xfactor]
_SPEC = re.compile(
    r"^(?P<kind>fail|rejoin|slow):(?P<node>\d+)@(?P<round>\d+)"
    r"(?:x(?P<factor>[0-9.]+))?$")


class FaultSchedule:
    """An ordered set of fault events plus status-replay queries.

    ``status_at(r, m)`` replays every event with index <= ``r`` and returns
    the per-node status vector: ``0.0`` for a failed node, otherwise the
    current slowdown factor (``1.0`` = nominal).  Engines stamp this vector
    onto ``RoundEvent.node_status`` so hooks observe membership.
    """

    def __init__(self, events: Iterable[FaultEvent],
                 num_nodes: int | None = None):
        self.events: tuple[FaultEvent, ...] = tuple(sorted(events))
        if num_nodes is not None:
            bad = [e for e in self.events if e.node >= num_nodes]
            if bad:
                raise ValueError(
                    f"fault schedule names node {bad[0].node} but the run "
                    f"has only {num_nodes} nodes")
        # a rejoin must follow a fail of the same node
        down: set[int] = set()
        for e in self.events:
            if e.kind == "fail":
                if e.node in down:
                    raise ValueError(
                        f"node {e.node} fails twice without a rejoin "
                        f"(second fail at {e.round})")
                down.add(e.node)
            elif e.kind == "rejoin":
                if e.node not in down:
                    raise ValueError(
                        f"node {e.node} rejoins at {e.round} without a "
                        "preceding fail")
                down.discard(e.node)

    # ------------------------------------------------------------------
    @classmethod
    def from_spec(cls, spec: str,
                  num_nodes: int | None = None) -> "FaultSchedule":
        """Parse ``"fail:1@3,rejoin:1@6,slow:2@4x2.5"`` (CLI surface)."""
        events = []
        for atom in filter(None, (s.strip() for s in spec.split(","))):
            m = _SPEC.match(atom)
            if not m:
                raise ValueError(
                    f"bad fault spec {atom!r}: expected "
                    "kind:node@round[xfactor] with kind in "
                    f"{_KINDS}, e.g. fail:1@3 or slow:2@4x2.5")
            events.append(FaultEvent(
                round=int(m["round"]), node=int(m["node"]), kind=m["kind"],
                factor=float(m["factor"]) if m["factor"] else 1.0))
        return cls(events, num_nodes=num_nodes)

    def validate_nodes(self, num_nodes: int) -> None:
        """Raise if any event names a node outside ``range(num_nodes)``."""
        bad = [e for e in self.events if e.node >= num_nodes]
        if bad:
            raise ValueError(
                f"fault schedule names node {bad[0].node} but the run "
                f"has only {num_nodes} nodes")

    @property
    def empty(self) -> bool:
        return not self.events

    def __iter__(self):
        return iter(self.events)

    def __len__(self):
        return len(self.events)

    # ------------------------------------------------------------------
    def status_at(self, r: int, m: int) -> np.ndarray:
        """Per-node status after every event with index <= ``r``:
        0.0 = failed, else the node's current slowdown factor."""
        slow = np.ones(m, dtype=np.float64)
        alive = np.ones(m, dtype=bool)
        for e in self.events:
            if e.round > r:
                break
            if e.kind == "fail":
                alive[e.node] = False
            elif e.kind == "rejoin":
                alive[e.node] = True
            else:
                slow[e.node] = e.factor
        return np.where(alive, slow, 0.0)

    def alive_at(self, r: int, m: int) -> np.ndarray:
        return self.status_at(r, m) > 0.0

    def between(self, lo: int, hi: int) -> Sequence[FaultEvent]:
        """Events with index in ``(lo, hi]`` — the incremental-replay slice
        event-driven consumers apply between two processed indices."""
        return [e for e in self.events if lo < e.round <= hi]
