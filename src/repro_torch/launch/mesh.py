"""Meshes for the multi-device outer layer, from ``repro/launch/mesh.py``.

A ``Mesh`` is a numpy object array of ``torch.device`` with named axes:
the single-controller counterpart of ``jax.sharding.Mesh``.  One process
drives every device of it, as the reference's ``shard_map`` does; there is
no process group, so ``torch.distributed.DeviceMesh`` is not used.

The device pool is explicit.  A builder takes ``devices=`` (any sequence
of ``torch.device``; the same device may repeat, so a pool of four
``cuda:0`` or eight ``cpu`` emulates a multi-device host, as the
reference's ``--xla_force_host_platform_device_count`` does) and defaults
to ``default_devices()``: the distinct CUDA devices, or one CPU device
where no card is visible.

``make_production_mesh`` builds the production shapes (``pod``, 16 x 16;
``multipod``, 2 x 16 x 16) over placeholder devices, by default the CPU
device repeated: the dry-run (``launch/dryrun.py``) reads only their
shape and axis names.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.sanitize import sanctioned_scope

__all__ = ["Mesh", "MESHES", "default_devices", "make_mesh",
           "make_nodes_mesh", "make_hybrid_mesh", "make_production_mesh",
           "placeholder_mesh", "data_axes", "place", "place_copy"]

MESHES = {
    "pod": ((16, 16), ("data", "model")),               # 256 chips (v5e pod)
    "multipod": ((2, 16, 16), ("pod", "data", "model")),  # 512 chips
    # reduced meshes for in-test dry-runs (subprocess with 8/16 devices)
    "tiny": ((2, 2), ("data", "model")),
    "tiny3d": ((2, 2, 2), ("pod", "data", "model")),
    # `nodes` family: 1-D meshes for the device-sharded BPT outer layer —
    # one device per computing node (the paper's m physical nodes).
    "nodes2": ((2,), ("nodes",)),
    "nodes4": ((4,), ("nodes",)),
    "nodes8": ((8,), ("nodes",)),
    "nodes16": ((16,), ("nodes",)),
    # `nodesNxmodelK` family: 2-D hybrid meshes — the paper's outer data
    # parallelism on `nodes` (§3, the Eq. 7 merge over this axis)
    # composed with per-layer inner parallelism on `model` (§4 via
    # core.planner).  K devices per computing node.
    "nodes2xmodel2": ((2, 2), ("nodes", "model")),
    "nodes4xmodel2": ((4, 2), ("nodes", "model")),
    "nodes2xmodel4": ((2, 4), ("nodes", "model")),
    "nodes8xmodel2": ((8, 2), ("nodes", "model")),
}


class Mesh:
    """An array of devices with named axes.

    ``devices`` is a numpy object array of ``torch.device``; ``shape``
    maps each axis name to its size, as ``jax.sharding.Mesh.shape`` does.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape, strict=True))

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    # -- the outer layer's view: node j's devices ------------------------
    def node_block(self, num_nodes: int) -> int:
        """Nodes a `nodes`-axis position holds (m / the axis size)."""
        size = self.shape["nodes"]
        if num_nodes % size:
            raise ValueError(f"{num_nodes} nodes do not divide the `nodes` "
                             f"mesh axis ({size})")
        return num_nodes // size

    def model_devices(self, node: int, num_nodes: int) -> tuple:
        """Node ``node``'s devices along the `model` axis (one device on a
        mesh without one); the first is the node's own device, where its
        weights and optimizer state live."""
        row = self.devices[node // self.node_block(num_nodes)]
        return tuple(np.atleast_1d(row).tolist())

    def node_device(self, node: int, num_nodes: int) -> torch.device:
        return self.model_devices(node, num_nodes)[0]


def default_devices() -> list:
    """The CUDA devices when PyTorch sees a card, else one CPU device."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _pool(devices) -> list:
    # ``cuda`` without an index names the current card, as the tensors'
    # own devices do (resolve_device raises where no card is visible)
    return [resolve_device(d) for d in
            (default_devices() if devices is None else devices)]


def make_mesh(name: str, devices=None) -> Mesh:
    shape, axes = MESHES[name]
    n = math.prod(shape)
    pool = _pool(devices)
    if len(pool) < n:
        raise RuntimeError(
            f"mesh {name} needs {n} devices, have {len(pool)} "
            "(pass a larger devices= pool)")
    return Mesh(np.asarray(pool[:n], dtype=object).reshape(shape), axes)


def make_nodes_mesh(num_nodes: int, devices=None) -> Mesh:
    """1-D ``nodes`` mesh for the device-sharded outer layer.

    One device per computing node, any node count — the named ``nodes<m>``
    MESHES entries are the documented members of the family; this builds
    the same shape for arbitrary m.  Raises RuntimeError when the pool
    has fewer than ``num_nodes`` devices (callers fall back to the
    single-device stacked emulation).
    """
    if num_nodes < 1:
        raise ValueError("need at least one node")
    pool = _pool(devices)
    if len(pool) < num_nodes:
        raise RuntimeError(
            f"nodes mesh needs {num_nodes} devices, have {len(pool)} "
            "(pass a devices= pool of that size, e.g. [torch.device('cpu')]"
            f" * {num_nodes}, to emulate a multi-device host)")
    return Mesh(np.asarray(pool[:num_nodes], dtype=object), ("nodes",))


def make_hybrid_mesh(num_nodes: int, model_parallel: int,
                     devices=None) -> Mesh:
    """2-D ``(nodes, model)`` hybrid mesh for arbitrary axis sizes.

    The ``nodesNxmodelK`` MESHES entries are the documented members of
    the family; this builds the same shape for any ``(N, K)``.  Each of
    the paper's m computing nodes owns ``model_parallel`` devices for
    the planner-driven inner layer.  Raises RuntimeError when the pool is
    too small (callers fall back like ``make_nodes_mesh``).
    """
    if num_nodes < 1 or model_parallel < 1:
        raise ValueError("need at least one node and one model shard")
    need = num_nodes * model_parallel
    pool = _pool(devices)
    if len(pool) < need:
        raise RuntimeError(
            f"hybrid mesh needs {need} devices "
            f"({num_nodes} nodes x {model_parallel} model), have "
            f"{len(pool)} (pass a devices= pool of {need} to emulate)")
    return Mesh(np.asarray(pool[:need], dtype=object).reshape(
        num_nodes, model_parallel), ("nodes", "model"))


def placeholder_mesh(name: str) -> Mesh:
    """``MESHES[name]`` over placeholder devices (the CPU device repeated),
    the counterpart of the reference's forced host-platform devices."""
    return make_mesh(name, [torch.device("cpu")] *
                     math.prod(MESHES[name][0]))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    return placeholder_mesh("multipod" if multi_pod else "pod")


def data_axes(mesh) -> tuple:
    """Mesh axes that carry the batch (outer-layer) dimension."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def place(tree, device):
    """``tree`` on ``device``, leaf by leaf (a leaf already there is
    returned as it is).  A copy between the card and the host makes the
    host wait for the card, so such a move is a sanctioned sync of the
    sanitizer, labelled ``node-move``; a copy between two CUDA devices
    is not."""
    device = resolve_device(device)
    crosses = _crosses(tree, device)
    if crosses is None:
        return tree
    if not crosses:
        return tree_map(lambda x: x.to(device), tree)
    with sanctioned_scope("node-move"):
        return tree_map(lambda x: x.to(device), tree)


def place_copy(tree, device):
    """``tree`` on ``device`` in buffers of its own (a node's replica:
    the rounds write into it, so it may not alias its source)."""
    moved = place(tree, device)
    return tree_map(torch.clone, moved) if moved is tree else moved


def _crosses(tree, device) -> Optional[bool]:
    """None when every leaf is on ``device`` already; else whether any
    leaf's copy goes between the host and the card."""
    types = {x.device.type for x in tree_leaves(tree)
             if x.device != device}
    if not types:
        return None
    return any(t != device.type for t in types)
