"""Inner-layer task decomposition and priority scheduling (§4, Alg. 4.2),
from ``repro/core/dag.py``.

The paper decomposes a CNN subnetwork's training step into a task DAG
(per-output-element convolution tasks, per-layer loss tasks, per-filter
gradient tasks), marks level-based priorities (upstream > downstream,
same level = same priority) and list-schedules onto threads, picking the
least-loaded thread for each ready task.

Pure Python and numpy, as in the reference, and equal to it choice for
choice: ``core.planner`` records the tiles ``choose_oc_tile`` and
``choose_fc_block`` pick in each ``LayerPlan``.  The port's CUDA kernels
choose their own launch geometry, so no kernel reads these tiles; the
scheduler reproduces the paper's thread-level load-balance and
critical-path-waiting metrics (Fig. 10, Fig. 14d).
"""
from __future__ import annotations

import dataclasses
import functools
import heapq
from typing import Iterable, Sequence

import numpy as np

__all__ = [
    "Task", "TaskDAG", "conv_layer_tasks", "cnn_training_dag",
    "priority_schedule", "ScheduleResult", "conv_output_shape",
    "conv_grid_tasks", "choose_oc_tile", "fc_grid_tasks", "choose_fc_block",
]


# ----------------------------------------------------------------------
# Task DAG
# ----------------------------------------------------------------------
@dataclasses.dataclass
class Task:
    tid: int
    name: str
    cost: float                      # execution duration estimate
    deps: tuple = ()                 # tids this task waits on
    level: int = 0                   # DAG level (entrance = 0)
    priority: int = 0                # higher runs earlier


class TaskDAG:
    def __init__(self):
        self.tasks: dict[int, Task] = {}
        self._next = 0

    def add(self, name: str, cost: float,
            deps: Iterable[int] = ()) -> int:
        tid = self._next
        self._next += 1
        self.tasks[tid] = Task(tid, name, float(cost), tuple(deps))
        return tid

    def __len__(self) -> int:
        return len(self.tasks)

    # -- priority marking (paper §4.2(1)) -------------------------------
    def mark_priorities(self, max_priority: int = 1_000_000) -> None:
        """Entrance tasks get the maximum value; each level down decrements.

        Upstream tasks' priorities are strictly higher than downstream's;
        tasks at the same level share the same priority.
        """
        # topological levels
        indeg = {t: len(self.tasks[t].deps) for t in self.tasks}
        children: dict[int, list[int]] = {t: [] for t in self.tasks}
        for t in self.tasks.values():
            for d in t.deps:
                children[d].append(t.tid)
        ready = [t for t, d in indeg.items() if d == 0]
        for t in ready:
            self.tasks[t].level = 0
        seen = 0
        queue = list(ready)
        while queue:
            u = queue.pop()
            seen += 1
            for v in children[u]:
                self.tasks[v].level = max(self.tasks[v].level,
                                          self.tasks[u].level + 1)
                indeg[v] -= 1
                if indeg[v] == 0:
                    queue.append(v)
        if seen != len(self.tasks):
            raise ValueError("task graph has a cycle")
        for t in self.tasks.values():
            t.priority = max_priority - t.level

    def critical_path(self) -> float:
        """Longest cost-weighted path (lower bound on makespan)."""
        order = sorted(self.tasks.values(), key=lambda t: t.level)
        finish: dict[int, float] = {}
        for t in order:
            start = max((finish[d] for d in t.deps), default=0.0)
            finish[t.tid] = start + t.cost
        return max(finish.values(), default=0.0)

    def total_work(self) -> float:
        return sum(t.cost for t in self.tasks.values())


# ----------------------------------------------------------------------
# Conv-layer decomposition (Eq. 12-14)
# ----------------------------------------------------------------------
def conv_output_shape(hx: int, wx: int, hf: int, wf: int,
                      stride: int = 1, pad: int = 0) -> tuple[int, int]:
    """Eq. (12): output feature-map height/width."""
    ha = (hx - hf + 2 * pad) // stride + 1
    wa = (wx - wf + 2 * pad) // stride + 1
    if ha <= 0 or wa <= 0:
        raise ValueError("filter larger than padded input")
    return ha, wa


def conv_layer_tasks(dag: TaskDAG, hx: int, wx: int, hf: int, wf: int,
                     stride: int = 1, pad: int = 0,
                     depth: int = 1, deps: Sequence[int] = (),
                     tile: int = 1, name: str = "conv") -> list[int]:
    """Eq. (13): K_C = H_a * W_a independent tasks, one per output element
    (or per `tile`x`tile` block — the BlockSpec analogue).

    Each task's cost = D_f*H_f*W_f multiply-adds per element * elements.
    Returns the created task ids (all mutually independent).
    """
    ha, wa = conv_output_shape(hx, wx, hf, wf, stride, pad)
    per_elem = depth * hf * wf
    tids = []
    for i0 in range(0, ha, tile):
        for j0 in range(0, wa, tile):
            elems = min(tile, ha - i0) * min(tile, wa - j0)
            tids.append(dag.add(f"{name}[{i0}:{j0}]", per_elem * elems, deps))
    return tids


def cnn_training_dag(layer_specs: Sequence[dict], tile: int = 4) -> TaskDAG:
    """Build the full forward+backward task DAG for a CNN (Fig. 9).

    ``layer_specs``: list of {"kind": "conv"|"pool"|"fc", ...dims}.
    Forward tasks chain layer-to-layer; backward tasks mirror them in
    reverse; weight-gradient tasks hang off the backward pass.
    """
    dag = TaskDAG()
    prev: list[int] = []
    fwd_layers: list[list[int]] = []
    for li, spec in enumerate(layer_specs):
        kind = spec["kind"]
        if kind == "conv":
            tids = conv_layer_tasks(
                dag, spec["hx"], spec["wx"], spec["hf"], spec["wf"],
                spec.get("stride", 1), spec.get("pad", 0),
                spec.get("depth", 1), prev, tile, name=f"fwd{li}")
        elif kind == "pool":
            ha, wa = conv_output_shape(spec["hx"], spec["wx"],
                                       spec["k"], spec["k"], spec["k"], 0)
            tids = [dag.add(f"pool{li}", ha * wa, prev)]
        elif kind == "fc":
            # one task per output-neuron block
            blocks = max(1, spec["out"] // max(spec.get("block", 64), 1))
            tids = [dag.add(f"fc{li}[{b}]", spec["in"] * spec["out"] / blocks,
                            prev) for b in range(blocks)]
        else:
            raise ValueError(kind)
        fwd_layers.append(tids)
        prev = tids

    # backward: per-layer error tasks (Eq. 18, parallel over neurons of
    # L_{l-1}) then weight-gradient tasks (Eq. 21, parallel over filters)
    bwd_prev = prev
    for li in range(len(layer_specs) - 1, -1, -1):
        err = [dag.add(f"bwd{li}.err[{b}]",
                       max(1.0, dag.tasks[t].cost * 0.5), bwd_prev)
               for b, t in enumerate(fwd_layers[li][: max(1, len(fwd_layers[li]) // 2)])]
        grad = [dag.add(f"bwd{li}.grad[{b}]",
                        max(1.0, dag.tasks[t].cost * 0.3), err)
                for b, t in enumerate(fwd_layers[li][: max(1, len(fwd_layers[li]) // 4)])]
        bwd_prev = err + grad
    return dag


# ----------------------------------------------------------------------
# Executed-grid decomposition (PT_Conv <-> the kernel grid)
# ----------------------------------------------------------------------
def conv_grid_tasks(dag: TaskDAG, batch: int, cout: int, oc_tile: int,
                    cost_per_channel: float = 1.0,
                    deps: Sequence[int] = (),
                    name: str = "pt_conv") -> list[int]:
    """The conv task grid: one task per (batch, oc-tile) grid cell.

    This is the paper's PT_Conv at the reference kernel's granularity —
    the grid is (batch, cout/oc_tile), each cell a kh*kw-matmul task over
    one output-channel tile.  All tasks are mutually
    independent; each costs ``oc_tile * cost_per_channel``.
    """
    if oc_tile <= 0 or cout % oc_tile:
        raise ValueError(f"oc_tile {oc_tile} must divide cout {cout}")
    cost = oc_tile * cost_per_channel
    return [dag.add(f"{name}[{b}:{c}]", cost, deps)
            for b in range(batch) for c in range(0, cout, oc_tile)]


@functools.lru_cache(maxsize=None)
def choose_oc_tile(batch: int, cout: int, workers: int = 8,
                   min_tile: int = 8) -> int:
    """Pick the output-channel tile for the executed conv grid (PT_Conv).

    For every candidate tile (divisors of ``cout`` no smaller than
    ``min_tile``, clamped to ``cout``) the candidate task grid is built with
    :func:`conv_grid_tasks` and list-scheduled with Alg. 4.2
    (:func:`priority_schedule`) over ``workers`` threads; the tile with the
    minimal makespan wins, larger tiles breaking ties (fewer, bigger
    tasks).  ``min_tile`` is the reference's floor on the tile (its
    kernel's lane width); the port keeps it so the choices stay equal.
    The port's conv kernels pick their own tiles and do not read this
    one (``core.planner``).
    """
    if batch < 1 or cout < 1:
        raise ValueError("batch and cout must be >= 1")
    floor = min(cout, max(1, min_tile))
    best_tile, best_makespan = cout, float("inf")
    for tile in range(cout, floor - 1, -1):
        if cout % tile:
            continue
        dag = TaskDAG()
        conv_grid_tasks(dag, batch, cout, tile)
        makespan = priority_schedule(dag, workers).makespan
        if makespan < best_makespan - 1e-9:
            best_tile, best_makespan = tile, makespan
    return best_tile


def fc_grid_tasks(dag: TaskDAG, d_out: int, block: int,
                  cost_per_neuron: float = 1.0, deps: Sequence[int] = (),
                  name: str = "pt_fc") -> list[int]:
    """The FC task grid: one task per output-neuron block.

    This is the paper's §4.1.2 G_FC granularity at the reference dense
    kernel's grid — (d_out/block,), each cell one
    ``(B, Din) x (Din, block)`` matmul task (the whole batch lives in one
    cell, unlike the conv grid's batch axis).  All tasks are mutually
    independent; each costs ``block * cost_per_neuron``.
    """
    if block <= 0 or d_out % block:
        raise ValueError(f"block {block} must divide d_out {d_out}")
    cost = block * cost_per_neuron
    return [dag.add(f"{name}[{n}]", cost, deps)
            for n in range(0, d_out, block)]


@functools.lru_cache(maxsize=None)
def choose_fc_block(d_out: int, workers: int = 8, min_block: int = 8) -> int:
    """Pick the output-neuron block for the executed dense grid (G_FC).

    The ``choose_oc_tile`` sibling for the FC stack: every candidate block
    (divisors of ``d_out`` no smaller than ``min_block``, clamped to
    ``d_out``) builds its task grid with :func:`fc_grid_tasks` and is
    list-scheduled with Alg. 4.2 (:func:`priority_schedule`) over
    ``workers`` threads; the block with the minimal makespan wins, larger
    blocks breaking ties (fewer, bigger tasks).  ``min_block`` is the
    reference's floor on the block (its kernel's lane width), kept so the
    choices stay equal; the port's dense kernel K1 picks its own tiles.
    """
    if d_out < 1:
        raise ValueError("d_out must be >= 1")
    floor = min(d_out, max(1, min_block))
    best_block, best_makespan = d_out, float("inf")
    for block in range(d_out, floor - 1, -1):
        if d_out % block:
            continue
        dag = TaskDAG()
        fc_grid_tasks(dag, d_out, block)
        makespan = priority_schedule(dag, workers).makespan
        if makespan < best_makespan - 1e-9:
            best_block, best_makespan = block, makespan
    return best_block


# ----------------------------------------------------------------------
# Priority list scheduling (Alg. 4.2)
# ----------------------------------------------------------------------
@dataclasses.dataclass
class ScheduleResult:
    makespan: float
    thread_busy: np.ndarray            # busy time per thread
    waiting_time: float                # sum of (start - ready) over tasks
    critical_path: float
    balance_degree: float              # min/max busy
    speedup: float                     # total_work / makespan

    def summary(self) -> dict:
        return {
            "makespan": round(self.makespan, 3),
            "waiting": round(self.waiting_time, 3),
            "balance": round(self.balance_degree, 4),
            "speedup": round(self.speedup, 3),
            "cp_bound": round(self.critical_path, 3),
        }


def priority_schedule(dag: TaskDAG, num_threads: int) -> ScheduleResult:
    """Alg. 4.2: order by priority, wait on deps, assign to the thread with
    minimal workload.  Event-driven so waits are exact."""
    if num_threads < 1:
        raise ValueError("need >= 1 thread")
    dag.mark_priorities()
    tasks = dag.tasks
    indeg = {t: len(tasks[t].deps) for t in tasks}
    children: dict[int, list[int]] = {t: [] for t in tasks}
    for t in tasks.values():
        for d in t.deps:
            children[d].append(t.tid)

    ready_time = {t: 0.0 for t in tasks if indeg[t] == 0}
    # ready heap ordered by (-priority, ready_time, tid)  — Alg 4.2 line 1
    ready = [(-tasks[t].priority, 0.0, t) for t in ready_time]
    heapq.heapify(ready)
    thread_free = np.zeros(num_threads)
    busy = np.zeros(num_threads)
    finish: dict[int, float] = {}
    waiting = 0.0

    while ready:
        _, r_time, tid = heapq.heappop(ready)
        k = int(np.argmin(thread_free))           # least-loaded thread
        start = max(thread_free[k], r_time)
        waiting += start - r_time
        end = start + tasks[tid].cost
        thread_free[k] = end
        busy[k] += tasks[tid].cost
        finish[tid] = end
        for v in children[tid]:
            indeg[v] -= 1
            if indeg[v] == 0:
                rt = max(finish[d] for d in tasks[v].deps)
                heapq.heappush(ready, (-tasks[v].priority, rt, v))

    if len(finish) != len(tasks):
        raise RuntimeError("schedule incomplete (cycle?)")
    makespan = max(finish.values(), default=0.0)
    total = dag.total_work()
    mx = float(busy.max()) if busy.size else 1.0
    return ScheduleResult(
        makespan=makespan,
        thread_busy=busy,
        waiting_time=waiting,
        critical_path=dag.critical_path(),
        balance_degree=float(busy.min() / mx) if mx > 0 else 1.0,
        speedup=total / makespan if makespan > 0 else 1.0,
    )
