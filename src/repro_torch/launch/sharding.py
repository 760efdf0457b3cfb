"""Per-architecture parameter/activation/cache sharding rules, from
``repro/launch/sharding.py``.

Parameters are matched by tree path suffix (the dict keys from the root,
joined by ``/``); every rule degrades to replication when the tensor dim
is not divisible by the mesh axis (so the same rules serve the 16-wide
model axis and the tiny test meshes).  The functions read only
``mesh.shape`` and ``mesh.axis_names``, so they take the port's ``Mesh``
or any stand-in with those two attributes, and return ``shardlib.P``
specs over the port's param, optimizer and cache trees.

Conventions (the leading layer axis of a stack is never sharded):
  * attention qkv in-proj  : columns on `model`   (head sharding)
  * attention out-proj     : rows on `model`
  * MLP wi/wg              : columns on `model`
  * MLP wo                 : rows on `model`
  * MoE experts            : expert axis on `model` (expert parallelism),
    else the per-expert FFN dim where the experts do not divide it
  * embeddings / lm head   : vocab on `model`
  * mamba mixer            : replicated
  * norms / scalars        : replicated

``param_shardings`` turns the specs into DTensor placements over a
``DeviceMesh`` (``shardlib.placements``), the counterpart of the
reference's ``NamedSharding``.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.shardlib import P, placements
from repro_torch.launch.mesh import data_axes

__all__ = ["param_specs", "param_shardings", "batch_specs", "cache_specs",
           "logical_rules", "opt_state_specs", "tree_map_with_path"]


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists, tuples and
    dataclasses (``lm.DecodeCache``); ``path`` holds the dict keys from the
    root.  List indices and dataclass fields are left out of it, as the
    reference's ``k.key`` filter leaves its sequence and attribute keys
    out."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map_with_path(fn, getattr(tree, f.name), path)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path) for v in tree)
    return fn(path, tree)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def _maybe(mesh, dim_size: int, axis):
    """Use `axis` if it divides dim_size, else replicate that dim."""
    return axis if dim_size % _axis_size(mesh, axis) == 0 else None


# ----------------------------------------------------------------------
# Parameters
# ----------------------------------------------------------------------
def _spec_for_path(keys: tuple, leaf, mesh) -> P:
    name = "/".join(keys)
    shape = tuple(leaf.shape)
    tp = "model"

    def col(idx_from_end=1):
        """Shard the given dim (from the end) on `model` if divisible."""
        ax = [None] * len(shape)
        dim = len(shape) - idx_from_end
        ax[dim] = _maybe(mesh, shape[dim], tp)
        return P(*ax)

    # embeddings & heads: vocab on model (first dim after optional stack)
    if name.endswith(("embed/table", "lm_head/table")):
        return P(_maybe(mesh, shape[0], tp), None)

    # attention projections
    if any(name.endswith(s) for s in ("wq/w", "wk/w", "wv/w")):
        return col(1)
    if "attn" in name and name.endswith("wo/w"):
        return col(2)
    if any(s in name for s in ("self_attn", "cross_attn")) and \
            name.endswith("wo/w"):
        return col(2)

    # MLP
    if any(name.endswith(s) for s in ("wi/w", "wg/w")) and "moe" not in name:
        return col(1)
    if name.endswith("mlp/wo/w"):
        return col(2)

    # MoE: experts on model (expert parallelism); router replicated.
    # Where E does not divide the axis (granite: 40 vs 16) the per-expert
    # FFN dim is sharded instead (expert tensor parallelism).
    if "moe" in name and keys[-1] in ("wi", "wg", "wo"):
        ax = [None] * len(shape)
        edim = len(shape) - 3          # (L, E, d, f) or (E, d, f)
        if shape[edim] % _axis_size(mesh, tp) == 0:
            ax[edim] = tp
        else:
            fdim = len(shape) - 1 if keys[-1] in ("wi", "wg") \
                else len(shape) - 2
            ax[fdim] = _maybe(mesh, shape[fdim], tp)
        return P(*ax)

    # frontend projector
    if name.endswith("frontend_proj/w"):
        return col(1)

    # everything else (norms, mamba mixer, biases, scalars): replicated
    return P(*([None] * len(shape)))


def param_specs(params, mesh):
    return tree_map_with_path(
        lambda path, leaf: _spec_for_path(path, leaf, mesh), params)


def param_shardings(params, device_mesh):
    """DTensor placements of every param on ``device_mesh`` (a
    ``DeviceMesh`` whose dim names are the mesh's axis names)."""
    shim = _MeshShape(device_mesh)
    return tree_map_with_path(
        lambda path, leaf: placements(_spec_for_path(path, leaf, shim),
                                      device_mesh), params)


class _MeshShape:
    """``mesh.shape`` and ``mesh.axis_names`` of a ``DeviceMesh``."""

    def __init__(self, device_mesh):
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.shape,
                              strict=True))


def opt_state_specs(opt_state, params, mesh):
    """AdamW moments share the param layout; counters are replicated."""
    pspecs = param_specs(params, mesh)

    def match(st):
        if isinstance(st, dict) and "mu" in st:
            return {"mu": pspecs, "nu": pspecs, "count": P()}
        if st == () or st is None:
            return st
        return tree_map_with_path(lambda _, __: P(), st)
    return match(opt_state)


# ----------------------------------------------------------------------
# Activations / logical rules
# ----------------------------------------------------------------------
def logical_rules(mesh, cfg=None) -> dict:
    dp = data_axes(mesh)
    tp = mesh.shape["model"]
    heads_ok = cfg is not None and cfg.num_heads and cfg.num_heads % tp == 0
    kv_ok = cfg is not None and cfg.num_kv_heads and cfg.num_kv_heads % tp == 0
    exp_ok = cfg is not None and cfg.num_experts and cfg.num_experts % tp == 0
    ff_ok = cfg is not None and cfg.d_ff and cfg.d_ff % tp == 0
    return {
        "batch": dp if dp else None,
        "seq": "model",       # sequence sharding at layer boundaries (SP)
        "embed": None,
        "vocab": "model",
        # attention computed head-sharded (the SP<->TP all-to-all at the
        # block boundary); kv heads replicate when GQA kv < |model|
        "heads": "model" if heads_ok else None,
        "kv_heads": "model" if kv_ok else None,
        "expert": "model" if exp_ok else None,
        # capacity-dim fallback sharding when experts can't split
        "capacity": None if exp_ok else "model",
        "mlp_ff": "model" if ff_ok else None,
        "kv_seq": "model",
        "tp": "model",
        "_axis_sizes": dict(mesh.shape),
    }


# ----------------------------------------------------------------------
# Inputs & caches
# ----------------------------------------------------------------------
def batch_specs(batch_shape_tree, mesh, mode: str):
    """Specs for the host batch: shard the batch dim over (pod, data)."""
    dp = data_axes(mesh)

    def spec(_, leaf):
        bt = _maybe(mesh, leaf.shape[0], dp)
        return P(bt, *([None] * (len(leaf.shape) - 1)))
    return tree_map_with_path(spec, batch_shape_tree)


def cache_specs(cache_tree, mesh, batch: int):
    """Decode caches (stacked over layers, leading L axis).

    kv k/v: (L, B, S, KH, D): batch over (pod, data) when divisible, else
    the *sequence* is context-sharded over every available axis
    (long_500k, batch = 1).  SSM state: (L, B, H, P, N): batch over dp,
    heads on model.  A ``DecodeCache``'s ``lengths`` (B,) follows the
    batch like any other leaf.
    """
    dp = data_axes(mesh)
    batch_ok = batch % _axis_size(mesh, dp) == 0

    def spec(keys, leaf):
        name = "/".join(keys)
        shp = tuple(leaf.shape)
        if keys and keys[-1] in ("k", "v") or "cross" in name:
            # (L, B, S, KH, D)
            if batch_ok:
                kh = _maybe(mesh, shp[3], "model")
                seq = "model" if kh is None else None
                seq = _maybe(mesh, shp[2], seq) if seq else None
                return P(None, dp, seq, kh, None)
            all_axes = tuple(mesh.axis_names)
            return P(None, None, _maybe(mesh, shp[2], all_axes), None, None)
        if keys and keys[-1] == "ssm":
            # (L, B, H, P, N)
            bt = dp if batch_ok else None
            return P(None, bt, _maybe(mesh, shp[2], "model"), None, None)
        if keys and keys[-1] == "conv":
            bt = dp if batch_ok else None
            return P(None, bt, None, _maybe(mesh, shp[3], "model"))
        bt = dp if batch_ok else None
        return P(bt, *([None] * (len(shp) - 1)))
    return tree_map_with_path(spec, cache_tree)
