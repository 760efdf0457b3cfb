"""Global Weight Updating strategies — SGWU (Eq. 7) and AGWU (Eq. 9-10),
from ``repro/core/gwu.py``, on trees of tensors (``core.tree``).

The merges are plain PyTorch ops on the tensors' own device; the
versioning and bookkeeping live in ``param_server.ParameterServer``.

JAX arrays are immutable and the reference leans on that; here every
function returns new tensors and writes into none of its inputs, so a
worker's Eq. 10 base (the global tree it pulled, held by reference) and a
merged global tree never move under a later write.  A node-stacked tree
is always materialised (one buffer per node), never an ``expand`` view:
a write into node j must reach neither the other nodes nor the merged
global weights.

On a mesh (``launch.mesh.Mesh``) the node axis is a list instead: a
node-sharded stack is a list of m trees, node j's resident on its mesh
device (``Mesh.node_device``).  ``sgwu_merge_and_rebroadcast_sharded`` is
Eq. 7 across those devices.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch.mesh import place

__all__ = ["sgwu_merge", "sgwu_merge_stacked", "sgwu_merge_and_rebroadcast",
           "broadcast_tree", "agwu_gamma", "agwu_update",
           "agwu_update_delta", "tree_sub", "tree_add_scaled",
           "sgwu_merge_and_rebroadcast_sharded"]


def tree_sub(a, b):
    """a - b, leafwise."""
    return tree_map(torch.sub, a, b)


def tree_add_scaled(base, delta, scale):
    """base + scale * delta, leafwise (scale is a scalar)."""
    return tree_map(lambda x, d: x + scale * d, base, delta)


def _weighted_leaf(nodes, weights):
    """sum_j nodes[j] * weights[j] as a chain of multiply-adds in node
    order: the fused multiply-adds the reference's XLA reduction contracts
    to.  ``nodes`` is a stacked leaf or a sequence of the nodes' leaves;
    ``weights`` a host tensor, taken as Python numbers in their dtype."""
    w = weights.to(nodes[0].dtype).tolist()
    acc = nodes[0] * w[0]
    for j in range(1, len(w)):
        acc.add_(nodes[j], alpha=w[j])
    return acc


def _weighted_sum(stacked, weights):
    """sum_j stacked[j] * weights[j] over the leading axis, leafwise."""
    return tree_map(lambda leaf: _weighted_leaf(leaf, weights), stacked)


def _merge_weights(accuracies, num_nodes: int) -> torch.Tensor:
    """Eq. (7) weighting Q_j / sum_k Q_k in f32, with the all-zero guard
    (all-zero accuracies degrade to the uniform average); on the host."""
    q = torch.from_numpy(np.asarray(accuracies, dtype=np.float32))
    total = q.sum()
    if float(total) > 0:
        return q / torch.clamp(total, min=1e-12)
    return torch.full_like(q, 1.0 / num_nodes)


def _validate_stack(stacked, accuracies) -> int:
    """Shared prologue of the stacked Eq. (7) entry points; returns m."""
    num_nodes = len(accuracies)
    if num_nodes == 0:
        raise ValueError("need at least one local weight set")
    leaves = tree_leaves(stacked)
    if leaves and leaves[0].shape[0] != num_nodes:
        raise ValueError(
            f"stacked leading axis {leaves[0].shape[0]} != "
            f"{num_nodes} accuracies")
    return num_nodes


def sgwu_merge_stacked(stacked, accuracies):
    """Eq. (7) against the node-stacked representation.

    ``stacked`` is one tree whose leaves carry a leading node axis of
    size m (worker j's weights at index j).
    """
    num_nodes = _validate_stack(stacked, accuracies)
    return _weighted_sum(stacked, _merge_weights(accuracies, num_nodes))


def sgwu_merge_and_rebroadcast(stacked, accuracies):
    """Eq. (7) merge plus the next round's replica stack.

    Returns ``(merged, new_stacked)``: ``new_stacked`` holds m copies of
    ``merged`` in buffers of its own (the reference donates ``stacked``
    for them; here ``stacked`` is left as it was).
    """
    merged = sgwu_merge_stacked(stacked, accuracies)
    return merged, broadcast_tree(merged, len(accuracies))


def sgwu_merge_and_rebroadcast_sharded(stacked: list, accuracies, mesh,
                                       device=None):
    """Eq. (7) across the devices of a ``nodes`` mesh.

    ``stacked`` is a node-sharded stack: a list of m trees, node j's on
    ``mesh.node_device(j, m)``.  Each node's leaf is moved to ``device``
    (the server's; default node 0's) and the weighted leaves are summed
    there in node order — the ops of ``sgwu_merge_stacked``, so the
    merged tree is the same floats as the single-device merge.  The merged
    tree is then copied back into each node's tree on its device (the
    reference donates the stack for this; here its buffers are written in
    place, so the caller hands ``stacked`` over).  Returns ``(merged,
    stacked)``.  A copy between the host and the card is a sanctioned sync
    (``node-move``).
    """
    num_nodes = len(accuracies)
    if num_nodes == 0:
        raise ValueError("need at least one local weight set")
    if len(stacked) != num_nodes:
        raise ValueError(f"{len(stacked)} node trees != {num_nodes} "
                         "accuracies")
    if num_nodes % mesh.shape["nodes"] != 0:
        raise ValueError(
            f"{num_nodes} nodes do not divide the `nodes` mesh axis "
            f"({mesh.shape['nodes']})")
    if device is None:
        device = mesh.node_device(0, num_nodes)
    weights = _merge_weights(accuracies, num_nodes)
    merged = tree_map(lambda *xs: _weighted_leaf(xs, weights),
                      *(place(t, device) for t in stacked))
    for j, tree in enumerate(stacked):
        node = place(merged, mesh.node_device(j, num_nodes))
        tree_map(lambda dst, src: dst.copy_(src), tree, node)
    return merged, stacked


def sgwu_merge(local_weights: Sequence, accuracies: Sequence[float]):
    """Eq. (7): W(i) = sum_j W_j(i-1) * Q_j / sum_k Q_k.

    ``local_weights`` is a list of trees with identical structure.
    """
    if len(local_weights) == 0:
        raise ValueError("need at least one local weight set")
    if len(local_weights) != len(accuracies):
        raise ValueError("one accuracy per local weight set")
    stacked = tree_map(lambda *xs: torch.stack(xs, dim=0), *local_weights)
    return sgwu_merge_stacked(stacked, accuracies)


def broadcast_tree(tree, num_nodes: int):
    """Replicate a tree along a new leading node axis of size m, one
    buffer per node (materialised, not a stride-0 view)."""
    return tree_map(
        lambda x: x.unsqueeze(0).expand((num_nodes,) + x.shape).clone(),
        tree)


def agwu_gamma(base_version: int, latest_version: int,
               outstanding_versions: Sequence[int]) -> float:
    """Eq. (9): time-attenuation factor.

    gamma_j(k) = e^{k/(i-1)} / sum_{j'} e^{k'/(i-1)}

    ``base_version`` is k (the global version the submitting node trained
    from); ``latest_version`` is i-1 (the server's current version);
    ``outstanding_versions`` are the base versions k' of the other nodes'
    in-flight local weight sets (the paper's denominator sums over all
    W_{j'}^{k'}, j' != j).  The submitter's own term is included so the
    factor is a proper share in [0, 1] even when it is the only one in
    flight (denominator then equals the numerator => gamma = 1).

    Pure Python/``math``: it runs on the host once per AGWU push.
    """
    denom_versions = list(outstanding_versions) + [base_version]
    i_minus_1 = max(latest_version, 1)
    num = math.exp(base_version / i_minus_1)
    den = sum(math.exp(v / i_minus_1) for v in denom_versions)
    return num / den


def _scale(gamma: float, accuracy: float) -> float:
    # the reference's f32 scalar, as a Python number: no tensor to place,
    # and PyTorch takes it into the leaves' f32 unchanged
    return float(np.float32(gamma * accuracy))


def agwu_update_delta(global_weights, delta, gamma: float, accuracy: float):
    """Eq. (10) from a precomputed delta W_j(k) - W(k): the same float ops
    as ``agwu_update`` (one multiply-add a element, as XLA fuses the
    reference's), split at the subtraction."""
    scale = _scale(gamma, accuracy)
    return tree_map(lambda g, d: torch.add(g, d, alpha=scale),
                    global_weights, delta)


def agwu_update(global_weights, local_weights, base_weights,
                gamma: float, accuracy: float):
    """Eq. (10): W(i) = W(i-1) + gamma * Q * (W_j(k) - W(k)).

    ``base_weights`` is the snapshot W(k) the worker trained from.  A new
    tree: neither the global weights nor the base (which may be the same
    tensors, right after a pull) is written.
    """
    scale = _scale(gamma, accuracy)
    return tree_map(lambda g, lw, b: torch.add(g, lw - b, alpha=scale),
                    global_weights, local_weights, base_weights)
