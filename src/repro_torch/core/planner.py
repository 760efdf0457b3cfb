"""Per-layer parallelization planner for the 2-D ``(nodes, model)`` mesh,
from ``repro/core/planner.py``.

BPT-CNN composes two parallel layers: outer data parallelism across the
m computing nodes (§3, the ``nodes`` mesh axis) and inner task
parallelism within each subnetwork (§4, the ``model`` axis: the K devices
of one node).  :func:`plan_network` walks the CNN layer by layer and
emits a :class:`LayerPlan` — parallel dimension ∈ {batch, channel,
replicate} on the ``model`` axis, the activation spec and the Alg. 4.2
tile — scored by roofline terms over ``launch.roofline.HW`` (the H100's
rates by default).  Given the reference's TPU figures the plan equals the
reference's field for field.  A ``PartitionSpec`` is a tuple of axis
names (or ``None``) here.

The plan is not advisory: ``ShardMapEngine`` executes what it says and
records what ran ("scheduled == executed").  The engine enters a
:func:`plan_scope` around each node's round with that node's model-axis
devices; ``kernels.ops`` consumes each layer's plan through :func:`take`.
A ``channel`` fc runs column-parallel over the node's K devices, built
from the three collectives below (:func:`rep_in`, :func:`shard_dim`,
:func:`gather_cols`), which keep the weight gradient exactly one tree.
``LayerPlan.tile`` is computed as the reference computes it and recorded,
but no kernel reads it: the port's CUDA kernels choose their own tiles.

The reference runs one program per device under ``shard_map``; the port
is one controller that loops over a node's model devices, so each
collective here takes all K shards at once (a list of tensors, one per
device) where the reference's takes one device's view and an axis name.

Two executable plan families (chain-consistent end to end):

- ``batch``:   every layer splits its batch over ``model``.  The
  per-shard losses and gradients are recombined by the exact
  sample-count-weighted sum of :func:`grad_combine` — an equality, not an
  approximation, for any per-example-mean loss (including the masked mean
  of uneven IDPA stripes).
- ``channel``: the batch stays whole; each fc layer independently goes
  column-parallel over ``model`` when its width divides, convs replicate.
  All gradient communication is the collectives' backward — no recombine
  step.

The Eq. 7 merge never changes: it stays a reduction over the nodes
(``core.gwu``), so §3 and §4 compose without interfering.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch.mesh import place
from repro_torch.launch.roofline import HW

__all__ = [
    "LayerPlan", "NetworkPlan", "plan_network", "plan_for_axes",
    "network_param_bytes", "plan_scope", "take", "current_plan",
    "current_devices", "grad_combine", "rep_in", "shard_dim",
    "gather_cols",
]

_F32 = 4                      # bytes per element (the CNN trains f32)
_BWD_MULT = 3.0               # fwd + backward ≈ 3x forward FLOPs


# ----------------------------------------------------------------------
# the plan
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One layer's resolved parallelization on the ``model`` mesh axis.

    ``parallel_dim`` is what executes: ``batch`` (activations split over
    ``model`` on the batch dim), ``channel`` (fc columns split, Megatron
    dataflow) or ``replicate`` (full compute on one of the node's
    devices).  ``spec`` is the activation spec inside one node's step;
    ``tile`` is the Alg. 4.2 choice (conv ``oc_tile`` / dense ``block``)
    **on the post-sharding local shapes** (0 for pool layers), recorded
    but read by no kernel.  ``shards``/``axis`` carry the model-axis
    geometry the executing op needs.
    """
    name: str                  # conv0, pool0, fc1, ...
    kind: str                  # "conv" | "pool" | "fc"
    parallel_dim: str          # "batch" | "channel" | "replicate"
    spec: tuple                # activation spec inside the node step
    tile: int                  # Alg. 4.2 tile (0: no tile knob)
    shards: int = 1            # model-axis size the plan was built for
    axis: str = "model"
    flops: float = 0.0         # per-device FLOPs (fwd+bwd) under the plan
    comm_bytes: float = 0.0    # per-step model-axis collective bytes
    cost_s: float = 0.0        # roofline seconds for this layer


@dataclasses.dataclass(frozen=True)
class NetworkPlan:
    """The per-layer plans plus the mesh-facing specs the engine uses.

    ``batch_spec`` is the stacked batch placement (leaves ``(nodes,
    local_steps, B, ...)``); ``param_spec`` the node-stacked param/opt
    placement.  ``combine_grads`` says whether the round must recombine
    per-shard grads with :func:`grad_combine` (the ``batch`` family).
    Hashable.
    """
    nodes: int
    model: int
    family: str                # "batch" | "channel" | "replicate"
    layers: tuple              # tuple[LayerPlan, ...] in forward order
    batch_spec: tuple
    param_spec: tuple
    combine_grads: bool
    total_cost_s: float
    axis: str = "model"


def network_param_bytes(cfg) -> int:
    """f32 bytes of one replica of the CNN's weights (Eq. 11 payload)."""
    from repro_torch.models.cnn import _conv_shapes
    shapes, final = _conv_shapes(cfg)
    total = 0
    for cin, cout, _, _ in shapes:
        total += (cfg.filter_size * cfg.filter_size * cin * cout + cout)
    dims = [final * final * cfg.filters] + \
        [cfg.fc_neurons] * (cfg.fc_layers - 1) + [cfg.num_classes]
    for j in range(cfg.fc_layers):
        total += dims[j] * dims[j + 1] + dims[j + 1]
    return total * _F32


# ----------------------------------------------------------------------
# roofline scoring (the cost model candidates are ranked by)
# ----------------------------------------------------------------------
def _roof(flops: float, mem_bytes: float, comm_bytes: float, hw: HW) -> float:
    return max(flops / hw.peak_flops, mem_bytes / hw.hbm_bw) \
        + comm_bytes / hw.ici_bw


def _allreduce_bytes(nbytes: float, k: int) -> float:
    """Ring all-reduce wire bytes per participant for a k-way sum."""
    return 2.0 * (k - 1) / k * nbytes if k > 1 else 0.0


def _gather_bytes(nbytes: float, k: int) -> float:
    """Ring all-gather wire bytes per participant (output size nbytes)."""
    return (k - 1) / k * nbytes if k > 1 else 0.0


def _candidate(dim: str, flops: float, mem: float, comm: float,
               hw: HW) -> dict:
    return {"dim": dim, "flops": flops, "comm": comm,
            "cost": _roof(flops, mem, comm, hw)}


def _conv_candidates(B: int, cin: int, cout: int, size: int, ksz: int,
                     K: int, hw: HW) -> dict:
    """Feasible model-axis parallelizations of one conv layer.

    ``channel`` conv (filter partitioning with summed partial outputs) is
    not executed by any op, so the planner does not offer it, keeping
    plan == execution honest.
    """
    flops = _BWD_MULT * 2.0 * B * size * size * ksz * ksz * cin * cout
    acts = _F32 * B * size * size * (cin + cout)
    wbytes = _F32 * (ksz * ksz * cin * cout + cout)
    out = {"replicate": _candidate("replicate", flops, acts + wbytes, 0.0,
                                   hw)}
    if K > 1 and B % K == 0:
        out["batch"] = _candidate(
            "batch", flops / K, acts / K + wbytes,
            _allreduce_bytes(wbytes, K), hw)
    return out


def _fc_candidates(B: int, d_in: int, d_out: int, K: int, hw: HW) -> dict:
    flops = _BWD_MULT * 2.0 * B * d_in * d_out
    a_in, a_out = _F32 * B * d_in, _F32 * B * d_out
    wbytes = _F32 * (d_in * d_out + d_out)
    out = {"replicate": _candidate("replicate", flops, a_in + a_out + wbytes,
                                   0.0, hw)}
    if K > 1 and B % K == 0:
        out["batch"] = _candidate(
            "batch", flops / K, (a_in + a_out) / K + wbytes,
            _allreduce_bytes(wbytes, K), hw)
    if K > 1 and d_out % K == 0:
        # fwd all-gather of the column-sharded output + the backward:
        # the dx sum (rep_in) and the weight gradient's blocks (shard_dim)
        comm = _gather_bytes(a_out, K) + _allreduce_bytes(a_in, K) \
            + _allreduce_bytes(wbytes, K)
        out["channel"] = _candidate(
            "channel", flops / K, a_in + (a_out + wbytes) / K, comm, hw)
    return out


def _pool_candidates(B: int, cout: int, size: int, K: int, hw: HW) -> dict:
    flops = _BWD_MULT * B * size * size * cout
    acts = _F32 * B * size * size * cout * 1.25
    out = {"replicate": _candidate("replicate", flops, acts, 0.0, hw)}
    if K > 1 and B % K == 0:
        out["batch"] = _candidate("batch", flops / K, acts / K, 0.0, hw)
    return out


_SPEC_OF = {
    # activation spec inside one node's step, by parallel dim:
    # batch-split rows / column-split features / whole
    "batch": ("model",),
    "channel": (None, "model"),
    "replicate": (),
}


def _walk_layers(cfg, B: int, K: int, hw: HW):
    """-> list of (name, kind, dims, candidates) in forward order."""
    from repro_torch.models.cnn import _conv_shapes
    shapes, final = _conv_shapes(cfg)
    walk = []
    for i, (cin, cout, size, pooled) in enumerate(shapes):
        walk.append((f"conv{i}", "conv", (cin, cout, size),
                     _conv_candidates(B, cin, cout, size, cfg.filter_size,
                                      K, hw)))
        if pooled:
            walk.append((f"pool{i}", "pool", (cout, size),
                         _pool_candidates(B, cout, size, K, hw)))
    dims = [final * final * cfg.filters] + \
        [cfg.fc_neurons] * (cfg.fc_layers - 1) + [cfg.num_classes]
    for j in range(cfg.fc_layers):
        walk.append((f"fc{j}", "fc", (dims[j], dims[j + 1]),
                     _fc_candidates(B, dims[j], dims[j + 1], K, hw)))
    return walk


def _tile_for(kind: str, dim: str, dims, B: int, K: int,
              workers: int) -> int:
    """The Alg. 4.2 tile on the plan's post-sharding local shapes."""
    from repro_torch.core.dag import choose_fc_block, choose_oc_tile
    if kind == "conv":
        _, cout, _ = dims
        local_b = B // K if dim == "batch" else B
        return choose_oc_tile(max(local_b, 1), cout, workers=workers)
    if kind == "fc":
        _, d_out = dims
        local_out = d_out // K if dim == "channel" else d_out
        return choose_fc_block(local_out, workers=workers)
    return 0


def plan_for_axes(cfg, *, nodes: int, model: int, batch_size: int = 32,
                  workers: int = 8, family: str = "",
                  hw: Optional[HW] = None) -> NetworkPlan:
    """Plan the network for explicit ``(nodes, model)`` axis sizes.

    The mesh-free core of :func:`plan_network` (no devices needed).
    ``family`` forces ``"batch"`` or ``"channel"``; ``""`` picks the
    cheaper feasible family.  ``cfg=None`` plans the generic
    model-agnostic batch family (no per-layer plans) — the 2-D engine's
    plan when the trainer has no ``CNNConfig``.  ``hw`` defaults to the
    H100's rates (``launch.roofline.HW``).
    """
    hw = hw or HW()
    K = max(int(model), 1)
    if cfg is None:
        if family and family != "batch":
            raise ValueError(
                f"family {family!r} needs a CNNConfig: only the generic "
                "batch plan is model-agnostic")
        if K > 1 and batch_size % K:
            raise ValueError(
                f"generic 2-D plan needs batch_size ({batch_size}) "
                f"divisible by the model axis ({K}); pass the model "
                "config for a per-layer channel/replicate plan")
        return NetworkPlan(
            nodes=nodes, model=K,
            family="batch" if K > 1 else "replicate", layers=(),
            batch_spec=("nodes", None, "model") if K > 1 else ("nodes",),
            param_spec=("nodes",), combine_grads=K > 1, total_cost_s=0.0)

    walk = _walk_layers(cfg, batch_size, K, hw)
    forced = bool(family)

    def assemble(fam: str):
        """-> (assignments, total_cost) or None when infeasible."""
        dims = []
        total = 0.0
        for _, kind, _, cands in walk:
            if fam == "batch":
                pick = cands.get("batch")
                if pick is None:
                    return None                  # batch % model mismatch
            elif fam == "channel":
                # per-layer choice: each fc independently column-parallel
                # when divisible AND cheaper; the batch stays whole so the
                # chain needs no resharding.  A FORCED channel family goes
                # column-parallel wherever divisible.
                pick = cands["replicate"]
                ch = cands.get("channel")
                if kind == "fc" and ch is not None \
                        and (forced or ch["cost"] < pick["cost"]):
                    pick = ch
            else:
                pick = cands["replicate"]
            dims.append(pick)
            total += pick["cost"]
        return dims, total

    if K == 1:
        family = family or "replicate"
    choices = {}
    for fam in ([family] if family else ["batch", "channel"]):
        got = assemble(fam)
        if got is None:
            if family:
                raise ValueError(
                    f"family 'batch' infeasible: batch_size "
                    f"({batch_size}) does not divide over the model "
                    f"axis ({K})")
            continue
        choices[fam] = got
    if not choices:
        raise ValueError("no feasible plan family")
    fam = min(choices, key=lambda f: choices[f][1])
    picks, total = choices[fam]

    layer_plans = []
    for (name, kind, dims, _), pick in zip(walk, picks, strict=True):
        layer_plans.append(LayerPlan(
            name=name, kind=kind, parallel_dim=pick["dim"],
            spec=_SPEC_OF[pick["dim"]],
            tile=_tile_for(kind, pick["dim"], dims, batch_size, K, workers),
            shards=K, flops=pick["flops"], comm_bytes=pick["comm"],
            cost_s=pick["cost"]))

    sharded_batch = fam == "batch" and K > 1
    return NetworkPlan(
        nodes=nodes, model=K, family=fam, layers=tuple(layer_plans),
        batch_spec=("nodes", None, "model") if sharded_batch
        else ("nodes",),
        param_spec=("nodes",), combine_grads=sharded_batch,
        total_cost_s=total)


def plan_network(cfg, mesh, batch_size: int = 32, workers: int = 8,
                 family: str = "", hw: Optional[HW] = None) -> NetworkPlan:
    """Per-layer parallelization plan for a concrete mesh.

    ``cfg`` is the ``CNNConfig`` (or None for the generic batch plan);
    ``mesh`` any mesh with a ``nodes`` axis — a ``model`` axis switches
    the inner layer on, its absence degrades to the 1-D outer layer.
    """
    shape = dict(mesh.shape)
    return plan_for_axes(cfg, nodes=shape.get("nodes", 1),
                         model=shape.get("model", 1),
                         batch_size=batch_size, workers=workers,
                         family=family, hw=hw)


# ----------------------------------------------------------------------
# plan scope: how the executing ops consume the plan
# ----------------------------------------------------------------------
class _PlanScope:
    """Cursor over a plan's layers, per kind.

    ``cnn_forward`` calls its conv/fc ops in a fixed order; each ``take``
    hands the next same-kind LayerPlan to the executing op and records it
    in ``executed`` — the log the "scheduled == executed" tests compare
    against the plan.  Counters wrap per kind, so every forward traversal
    realigns.  The reference records at every take of a trace, which runs
    once; here every eager forward takes, so ``executed`` holds the first
    traversal only (up to the first take whose kind has wrapped).
    ``devices`` are the node's model-axis devices the channel collectives
    place shards on.
    """

    def __init__(self, plan: NetworkPlan, devices: Sequence = ()):
        self.plan = plan
        self.devices = tuple(devices)
        self._by_kind: dict = {}
        for lp in plan.layers:
            self._by_kind.setdefault(lp.kind, []).append(lp)
        self._cursor = {k: 0 for k in self._by_kind}
        self._taken: set = set()
        self._recording = True
        self.executed: list = []

    def take(self, kind: str) -> Optional[LayerPlan]:
        seq = self._by_kind.get(kind)
        if not seq:
            return None
        i = self._cursor[kind]
        self._cursor[kind] = (i + 1) % len(seq)
        lp = seq[i]
        if i == 0 and kind in self._taken:
            self._recording = False          # the second traversal began
        self._taken.add(kind)
        if self._recording:
            self.executed.append(lp)
        return lp


_SCOPES: list = []


@contextlib.contextmanager
def plan_scope(plan: NetworkPlan, devices: Sequence = ()):
    """Install ``plan`` for the ops called in this block (re-entrant);
    ``devices`` are the node's model-axis devices."""
    sc = _PlanScope(plan, devices)
    _SCOPES.append(sc)
    try:
        yield sc
    finally:
        _SCOPES.pop()


def take(kind: str) -> Optional[LayerPlan]:
    """The executing op's hook: the next ``kind`` LayerPlan, or None
    when no plan scope is active (every non-planned path)."""
    return _SCOPES[-1].take(kind) if _SCOPES else None


def current_plan() -> Optional[NetworkPlan]:
    return _SCOPES[-1].plan if _SCOPES else None


def current_devices() -> tuple:
    """The active scope's model-axis devices (empty outside a scope)."""
    return _SCOPES[-1].devices if _SCOPES else ()


# ----------------------------------------------------------------------
# batch family: exact per-shard loss/grad recombination over `model`
# ----------------------------------------------------------------------
def grad_combine(plan: NetworkPlan):
    """The model-axis recombiner for batch-family rounds.

    ``combine(losses, grads, batches, device) -> (loss, grads)`` takes
    the K shards' losses, gradient trees and batches (shard k's on its
    device) and returns the full-batch loss and gradient on ``device``.
    Each shard's values are weighted by its (mask-aware) sample count over
    the total and summed in shard order, which reproduces the full-batch
    mean gradient EXACTLY — for the plain mean and for the masked mean of
    uneven stripes (the gradient of ``Σlm/Σm`` decomposes as
    ``Σ(M_s·g_s)/ΣM_s``).  Runs before gradient clipping, so clipping sees
    the same global norm the unsplit paths clip.
    """
    del plan             # the shard count is len(losses)

    def combine(losses, grads, batches, device):
        masks = [b.get("mask") if isinstance(b, dict) else None
                 for b in batches]
        if all(m is None for m in masks):
            # host numbers (no tensor to place): the f32 shares the
            # reference's psum of row counts gives
            rows = [np.float32(tree_leaves(b)[0].shape[0]) for b in batches]
            total = max(np.float32(sum(rows)), np.float32(1.0))
            shares = [float(np.float32(r / total)) for r in rows]
        else:
            ws = [place(m.to(torch.float32).sum(), device) for m in masks]
            total = torch.clamp(sum(ws[1:], ws[0]), min=1.0)
            shares = [w / total for w in ws]

        def wsum(*xs):
            acc = place(xs[0], device) * _like(shares[0], xs[0])
            for x, s in zip(xs[1:], shares[1:]):
                acc = acc + place(x, device) * _like(s, x)
            return acc

        return wsum(*losses), tree_map(wsum, *grads)

    return combine


def _like(share, x):
    return share.to(x.dtype) if isinstance(share, torch.Tensor) else share


# ----------------------------------------------------------------------
# channel family: the collectives of the column-parallel fc
# ----------------------------------------------------------------------
# One controller holds all K shards, so each collective takes or returns
# the whole list.  Moves between devices go through ``launch.mesh.place``
# (a move between the host and the card is a sanctioned sync).  Their backward passes are written out so that the
# gradient of a weight is one full tree, assembled exactly from its
# column blocks, and the input's gradient is the shards' partial sums
# added in shard order.

class _RepIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, devices):
        ctx.device = x.device
        return tuple(x.view_as(x) if d == x.device else place(x, d)
                     for d in devices)

    @staticmethod
    def backward(ctx, *gs):
        acc = None
        for g in gs:
            if g is not None:
                g = place(g, ctx.device)
                acc = g if acc is None else acc + g
        return acc, None


def rep_in(x, devices: Sequence) -> tuple:
    """``x`` on each of the node's model devices (the identity forward);
    the backward sums the K shards' partial cotangents, in shard order,
    into the one gradient of ``x``."""
    return _RepIn.apply(x, tuple(devices))


class _ShardDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, devices):
        ctx.device, ctx.shape, ctx.dtype = x.device, x.shape, x.dtype
        blk = x.shape[-1] // len(devices)
        return tuple(place(x[..., k * blk:(k + 1) * blk].contiguous(), d)
                     for k, d in enumerate(devices))

    @staticmethod
    def backward(ctx, *gs):
        blk = ctx.shape[-1] // len(gs)
        parts = [torch.zeros(ctx.shape[:-1] + (blk,), dtype=ctx.dtype,
                             device=ctx.device)
                 if g is None else place(g, ctx.device) for g in gs]
        return torch.cat(parts, dim=-1), None


def shard_dim(x, devices: Sequence) -> tuple:
    """``x``'s last dim cut into K equal column blocks, block k copied
    contiguous onto device k (a ``(Din, Dout)`` weight's column block is
    not contiguous in memory, and the kernels take contiguous operands).
    The backward concatenates the K blocks' cotangents on ``x``'s device:
    the weight's gradient comes back full and exact."""
    if x.shape[-1] % len(devices):
        raise ValueError(f"last dim {x.shape[-1]} does not split over "
                         f"{len(devices)} shards")
    return _ShardDim.apply(x, tuple(devices))


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, device, *ys):
        ctx.devices = [y.device for y in ys]
        ctx.widths = [y.shape[-1] for y in ys]
        return torch.cat([place(y, device) for y in ys], dim=-1)

    @staticmethod
    def backward(ctx, g):
        parts = torch.split(g, ctx.widths, dim=-1)
        return (None, *(place(p.contiguous(), d)
                        for p, d in zip(parts, ctx.devices, strict=True)))


def gather_cols(ys: Sequence, device) -> torch.Tensor:
    """The K column shards concatenated into the full activation on
    ``device`` (the node's own); the backward hands each shard its slice
    of the cotangent, on its device."""
    return _GatherCols.apply(torch.device(device), *ys)
