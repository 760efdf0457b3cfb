"""Logical-axis sharding rules (MaxText-style), from
``repro/core/shardlib.py``.

Models annotate activations with *logical* axis names
(``constrain(x, "batch", "seq", "embed")``); the dry-run installs a
mapping from logical names to mesh axes (``set_rules``).  With no rules
installed (every CPU and card path of the port) the calls are no-ops
that return the very object they were given, so the same model code runs
everywhere.

A spec (``P``) holds exactly what the reference's ``PartitionSpec``
holds: one entry per tensor dim, each a mesh axis name (``str``), a tuple
of axis names (one dim split over several mesh axes, major axis first) or
``None`` (that dim replicated).  ``placements`` turns a spec into the
DTensor placements over a ``DeviceMesh`` whose dim names are the mesh's
axis names; ``constrain`` is ``DTensor.redistribute`` to them, the
counterpart of ``jax.lax.with_sharding_constraint``.  A tensor that is
not a DTensor passes through unchanged even with rules installed.
"""
from __future__ import annotations

import contextlib
from typing import Optional

__all__ = ["P", "set_rules", "get_rules", "constrain", "constrain_div",
           "rules_scope", "spec_for", "placements"]

_RULES: Optional[dict] = None


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "data"))``.  As the
    reference's ``PartitionSpec`` does, a one-axis tuple is held as that
    axis and an empty one as ``None``."""

    def __new__(cls, *axes):
        return super().__new__(cls, (_canonical(a) for a in axes))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _canonical(axis):
    if isinstance(axis, (tuple, list)):
        axis = tuple(axis)
        return None if not axis else axis[0] if len(axis) == 1 else axis
    return axis


def set_rules(rules: Optional[dict]) -> None:
    """rules: {logical_name: mesh axis (str | tuple | None)}."""
    global _RULES
    _RULES = rules


def get_rules() -> Optional[dict]:
    return _RULES


@contextlib.contextmanager
def rules_scope(rules: Optional[dict]):
    global _RULES
    prev = _RULES
    _RULES = rules
    try:
        yield
    finally:
        _RULES = prev


def spec_for(*logical_axes: Optional[str]) -> P:
    assert _RULES is not None
    return P(*(_RULES.get(a) if a is not None else None
               for a in logical_axes))


def _axis_size(axis) -> int:
    sizes = (_RULES or {}).get("_axis_sizes", {})
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes.get(a, 1)
        return n
    return sizes.get(axis, 1)


def placements(spec, device_mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``device_mesh``: tensor dim
    ``i`` mapped to an axis gives ``Shard(i)`` on that mesh dim, every
    other mesh dim ``Replicate()``.  Where a tuple of axes shards one dim,
    the mesh dims split it in the tuple's order (major first), as the
    reference's device order does."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            i = names.index(a)
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {a!r} shards two dims of {spec}")
            out[i] = Shard(dim)
    return tuple(out)


def _redistribute(x, spec):
    # reached only with rules installed (the dry-run's)
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = placements(spec, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def constrain_div(x, *logical_axes: Optional[str]):
    """Like constrain, but replicates any dim the mapped mesh axis does not
    divide (needs "_axis_sizes" in the rules)."""
    if _RULES is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(f"{len(logical_axes)} axes for a {x.ndim}-D tensor")
    spec = []
    for dim, a in zip(x.shape, logical_axes, strict=True):
        ax = _RULES.get(a) if a is not None else None
        spec.append(ax if ax is not None and dim % _axis_size(ax) == 0
                    else None)
    return _redistribute(x, P(*spec))


def constrain(x, *logical_axes: Optional[str]):
    """Redistribute ``x`` to the rules' spec if rules are installed and
    ``x`` is a DTensor, else return ``x`` itself."""
    if _RULES is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(f"{len(logical_axes)} axes for a {x.ndim}-D tensor")
    return _redistribute(x, spec_for(*logical_axes))
