"""Runtime sanitizer of the port, from ``repro/sanitize/harness.py``.

It catches the two failure classes that exist only at run time:

* **Hidden syncs.**  ``sanitized()`` arms PyTorch's CUDA sync debug mode
  (``torch.cuda.set_sync_debug_mode("error")``) for its scope, so any
  operation inside an engine round that makes the host wait for the
  card — ``.item()``, ``float()`` or ``.cpu()`` of a CUDA tensor, a
  blocking host-to-device ``copy_`` from pageable memory, a
  ``torch.cuda.synchronize()`` — raises instead of stalling the
  pipeline.  This is the port's counterpart of the reference's
  ``jax.transfer_guard``: where JAX forbids implicit transfers, PyTorch
  can forbid the syncs they cost.  Host syncs that are supposed to
  happen (the Eq. 8 measured-wall boundary, accuracy evals feeding Eq.
  7/10, the batch uploads) run inside ``sanctioned_sync()`` /
  ``sanctioned_scope()``, which disarm the mode and record their labels
  in ``sync_log()``.
* **Silent recompiles.**  The port compiles one thing at run time: the
  kernel libraries, one ``nvcc`` each, at their first use
  (``kernels/build.py``).  ``compile_counts()`` reads build's count of
  ``nvcc`` runs and ``compile_budget(n)`` asserts a scope built at most
  ``n``; a steady-state round holds ``compile_budget(0)``.

Everything is gated on ``REPRO_SANITIZE`` (off by default).  With the
gate off, ``sanitized`` is a no-op and ``sanctioned_sync`` still pulls
its values to the host.

The CPU half: on a machine without a card, or for a trainer on the CPU,
there is nothing to sync with, and ``sanitized`` arms nothing (the mode
exists only in a CUDA build of PyTorch, and a CPU tensor never syncs).
The labels of ``sync_log()`` are recorded all the same, so the order of
the sanctioned syncs is checked on the CPU too.

Labels: the reference's ``scan.loss``, ``round.losses``,
``local-round.loss``, ``eval`` and ``measured-timer.<kind>``, and two the
reference does not have: ``upload`` (``jax.device_put`` places a numpy
batch without a sync, while ``Tensor.to("cuda")`` from pageable host
memory waits for the copy, so each batch upload is a sanctioned sync
here) and ``node-move`` (``launch.mesh.place``: a tree moved between the
host and the card, as a mixed pool's merge and replicas move them).
"""
from __future__ import annotations

import contextlib
import os
import threading

import numpy as np
import torch

from repro_torch.core.tree import tree_map
from repro_torch.kernels import build

__all__ = [
    "sanitize_enabled", "sanitized", "sanctioned_scope", "sanctioned_sync",
    "sync_log", "clear_sync_log", "compile_counts", "compile_budget",
    "CompileBudgetExceeded",
]


def sanitize_enabled() -> bool:
    """True when the REPRO_SANITIZE env gate is on ("", "0", "off" = off)."""
    return os.environ.get("REPRO_SANITIZE", "").lower() not in ("", "0", "off")


@contextlib.contextmanager
def _sync_mode(mode):
    """Set the CUDA sync debug mode for the scope; restore the previous
    one on exit, so scopes nest."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def sanitized(label: str = ""):
    """Arm the sync guard around an engine round body.

    Inside the scope every operation that synchronises the host with the
    card raises ``RuntimeError``.  Kernel launches, device-side ops and
    allocations stay legal: the point is that every wait is visible in
    the code.  No-op when ``REPRO_SANITIZE`` is off or no card is
    visible.
    """
    if not sanitize_enabled() or not torch.cuda.is_available():
        yield
        return
    with _sync_mode("error"):
        yield


# audit trail of sanctioned sync points, most recent last
_sync_log: list = []
_sync_lock = threading.Lock()


def sync_log() -> list:
    """Labels of every sanctioned sync since the last clear (copy)."""
    with _sync_lock:
        return list(_sync_log)


def clear_sync_log() -> None:
    with _sync_lock:
        _sync_log.clear()


@contextlib.contextmanager
def sanctioned_scope(label: str):
    """The audited escape hatch: syncs are allowed inside, and the scope
    is recorded in ``sync_log()`` when it ends.  Use it where a host sync
    IS the semantics — measured-wall boundaries, accuracy evals whose
    scalar feeds Eq. 7/10, batch uploads."""
    if sanitize_enabled() and torch.cuda.is_available():
        with _sync_mode(0):
            yield
    else:
        yield
    with _sync_lock:
        _sync_log.append(label)


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def sanctioned_sync(x, label: str = "sync"):
    """Pull ``x`` (a tensor or a tree of them) to the host as a
    sanctioned sync; returns the tree with every leaf an ``np.ndarray``.

    Engine code that must read a device value (per-node losses for a
    ``RoundEvent``, eval scalars) calls this instead of ``.cpu()`` so the
    read stays legal under ``sanitized()`` and lands in the audit log.
    """
    with sanctioned_scope(label):
        return tree_map(_to_numpy, x)


# ----------------------------------------------------------------------
# compile budgets
# ----------------------------------------------------------------------
class CompileBudgetExceeded(AssertionError):
    """A ``compile_budget`` scope compiled more than it promised."""


def compile_counts() -> dict:
    """Cumulative counter of this process: ``compiles``, the ``nvcc``
    runs ``kernels/build.py`` started."""
    return {"compiles": build.compiles()}


@contextlib.contextmanager
def compile_budget(n: int, label: str = ""):
    """Assert the scope builds at most ``n`` kernel libraries.

    ``compile_budget(0)`` is the steady-state contract: a warmed path
    builds nothing.  Raises ``CompileBudgetExceeded`` (an AssertionError)
    on overrun.
    """
    before = build.compiles()
    yield
    spent = build.compiles() - before
    if spent > n:
        where = f" [{label}]" if label else ""
        raise CompileBudgetExceeded(
            f"compile budget exceeded{where}: {spent} compiles > budget "
            f"{n} — a warmed path built a kernel library (a source or "
            "header that changed, or a kernel first used here)")
