"""Multi-pod dry-run: build and run every (arch x shape x mesh) step over
placeholder devices, from ``repro/launch/dryrun.py``.

Run it as ``python -m repro_torch.launch.dryrun``; it needs no card.

The reference lowers one SPMD step on 512 placeholder host devices and
GSPMD adds the collectives.  The port's counterpart is DTensor over a
*fake* process group in one process:

  1. a fake group of ``mesh.size`` ranks (``FakeStore``), created inside
     ``lower_and_compile`` and destroyed after it (no import creates one),
     and a ``DeviceMesh`` with the mesh's shape and axis names;
  2. every param, optimizer leaf, batch leaf and cache leaf a DTensor of
     fake CPU tensors (``FakeTensorMode``: shapes, no storage), placed by
     ``launch.sharding``'s specs (``shardlib.placements``), built from
     its local shard without a collective;
  3. one eager run of the step (``launch.steps``) with the logical rules
     installed, so ``shardlib.constrain`` redistributes at the reference's
     sites.  The tensors are fake CPU tensors, so every kernel call takes
     its plain version (``kernels/ops.py`` dispatches by device type);
  4. ``_StepRecorder``, a dispatch mode under DTensor, sees the local ops
     that device 0 runs and records:
     - FLOPs: what ``torch.utils.flop_counter`` counts for each local op
       (its formula table; matmul-class ops);
     - bytes: the inputs and outputs of every local aten op that is not a
       view, which is the traffic of the eager plain path;
     - collectives: ``roofline.CollectiveRecorder``, kind -> output bytes
       on one device (the counterpart of parsing the compiled HLO);
     - temp: the peak of live local bytes allocated during the step (its
       outputs included: the eager step donates nothing);
     FLOPs, bytes and collective bytes are multiplied by the chips, as
     the reference multiplies its per-device cost analysis: replicated
     work counts on every device that does it;
  5. records everything into ``experiments/dryrun_torch/<arch>__<shape>__
     <mesh>.json``.

Depth.  An eager fake run costs time in proportion to the layers times
the attention blocks, so the full depth is never run: the 1- and 2-layer
configurations (``_calib_cfg``, at the config's own attention chunks,
not widened) are, and every count and the temp peak are extrapolated to
L layers as ``calibrated_costs`` does (``per_layer``, ``outside``).  The
record's ``full_artifact`` is the 1-layer run (the reference's counts
its loop bodies once), and ``extrapolated`` names the fields that come
from the extrapolation.  Argument bytes are computed exactly at full depth
from the specs; output bytes from the two runs, which is exact because
every output leaf is either per layer or layer-free.

No score corrections.  ``_attn_score_bytes`` and ``_banded_flops_corr``
are ported and recorded as the reference records them, but not
subtracted: the port's counts never include widened score matrices (the
chunks are never widened), and under ``attn_block_skip`` the skipped kv
blocks are really skipped (``models.attention.live_block``).

Where DTensor has no sharding rule for an op, or one GSPMD does not
share, the dry-run adjusts it; each site may add or drop collectives
against GSPMD's, and the records count them (``view_replications``,
``retries``):
  - ``aten.searchsorted`` (``models/moe.py``'s dispatch): a registered
    rule computes it on replicated operands (the sorted expert ids are
    all-gathered);
  - ``aten.scatter.src`` (the MoE dispatch's buffer): a registered rule,
    torch 2.13's own, sharded on any dim but the scattered one where
    every operand has the same size there (2.11's replicated every
    operand: the dispatch's (B, S k, d) index and copies all-gathered);
  - a view that would split or flatten a sharded dim in a way DTensor
    cannot shard (Yi-6B's 4 kv heads over a 16-wide `model` axis; a head
    count the axis does not divide; older DTensor also refuses to
    flatten a batch- and sequence-sharded tensor) is taken after its
    input is replicated on that mesh axis; a product
    (``torch.einsum``, ``x @ w``) whose view DTensor replicates so
    (2.11: attention's scores and p @ v, the MoE router) is taken again
    shard by shard, the attempt's counts dropped (``_local_products``);
  - ``aten.bmm`` with both operands sharded on the batch dim only, a
    strided shard included (an einsum flattens a batch- and a
    head-sharded dim into it), runs shard by shard, where DTensor would
    gather the strided batch first;
  - ``aten.logsumexp`` (the loss's vocab-sharded logits) and
    ``aten._softmax`` (decode attention's scores over a
    sequence-sharded cache) over a sharded dim are reduced as a max and
    a sum, each all-reduced on its small result, where DTensor would
    gather the input;
  - ``aten.constant_pad_nd`` (the mamba mixer's causal conv), where a
    torch version's rule fails, is taken again on a replicated operand
    (``_RETRIED``); a replicated output that 2.11's pad rule gives one
    placement is given one a mesh dim (``_every_mesh_dim``);
  - where a torch version (2.11) has no rule for them: ``aten.detach_``
    (autograd's, in the backward's redistributions) takes that version's
    ``aten.detach`` rule, and ``aten.flip`` (``cumsum``'s backward, in
    the mamba mixer's SSD) a registered one, sharded on any dim it does
    not reverse; both keep the placements, no collective;
  - ``_dtensor.shard_dim_alltoall``: on a CPU mesh DTensor would gather
    and chunk instead of the all-to-all a GPU mesh issues; the dry-run
    issues the all-to-all (``_cpu_mesh_alltoall``).
DTensor internals run outside the recorder where they are not the
step's: its sharding and shape propagation of each new op schema
(``_meta_propagation_unrecorded``, and a warm-up step before the
recorded ones) and ``_StridedShard``'s host-side size arithmetic
(``_strided_shard_shapes``); a vocab-sharded gather whose size-1 dim is
selected before its reduction gets its mask reshaped
(``_mask_after_select``).

For the step's run the dry-run swaps in its own versions of model
functions (``_sharded_model_paths``; the card and CPU paths never take
them, and the models and ``kernels/ops.py`` hold no DTensor branch), so
that each issues the collective the reference's compiled HLO issues
there, on the same bytes; each record counts, per swapped name, the
calls that took the dry-run's own path (``swaps``):
  - ``ops._dense_call``: each device contracts its own shards on x's
    leading dims (``_local_einsum``; no flatten into rows) after
    ``_dense_layout`` places the operands as GSPMD places them: the
    weight gathered where x is sharded on its batch or sequence (never
    x, once per projection), its gradient reduce-scattered back, except
    in training where the product goes straight to a constraint on the
    weight's sharded columns (v's projection, ``attention.project_qkv``
    below): there x is gathered over its sequence and the weight stays;
    x gathered (or reduced) once where its contraction is split and the
    weight's output is sharded; in prefill and training a replicated
    x's sequence sliced before a row-sharded weight; in decode a
    replicated weight split on its output columns where it widens (the
    mamba mixer's ``in_proj``), else on its contraction with x, as the
    reference's HLO splits them.  A partial product is all-reduced at
    once, as GSPMD reduces a dot, where DTensor would carry it into the
    residual stream (in training, reduce-scatter it at the block's
    constraint); in training its gradient comes back whole, as the
    transpose of GSPMD's all-reduce, and x's gradient, a partial sum
    where the weight's columns are split, is all-reduced at once;
  - ``attention.project_qkv`` (training): the model's own, with the
    weights whose products go straight to their head constraint marked
    for ``_dense_layout`` (v's; in cross-attention, which ropes
    neither, q's and k's too, unless a qk norm comes between);
  - ``lm._ce_chunk``: the model's own, with a head table the model axis
    does not divide (left replicated by the specs: Hymba's 32001 rows,
    InternVL2's 92553, Granite-MoE's 49155) split on its rows where it
    lies, as GSPMD pads and splits it: the logits leave the product
    vocab-sharded and their gradient stays so (DTensor sliced the
    replicated logits at their constraint and gathered their gradient
    whole, 8.4 GB a device for Hymba at 1024 tokens on ``tiny``);
  - ``steps.value_and_grad`` (training): the model's own, each partial
    gradient (a replicated weight's) all-reduced once as it leaves the
    backward, as GSPMD reduces it, where DTensor reduced it again at
    every optimizer op that needs it whole (twice, on 2.11 three times);
  - ``shardlib._redistribute`` (training): a constraint whose gradient
    is laid out as its forward (``_Constraint``), as the transpose of the
    reference's ``with_sharding_constraint`` is; DTensor sends it back
    to the input's placements, or, where the input already lies so,
    leaves it as it comes, so the gradient entering a block differed
    between the last layer (from the loss) and the others (Granite-MoE's
    MoE backward all-to-all'ed it in every layer but the last, and its
    ``outside`` came out negative);
  - ``ops.rmsnorm``: the plain version on x's leading dims;
  - ``layers.embed`` (and the names ``lm`` and ``encdec`` import it
    under), in every mode: a vocab-parallel lookup, each shard its own
    rows and zeros elsewhere, all-reduced once; the table never moves
    (``index_select`` has no such DTensor rule: the whole table was
    all-to-all'ed);
  - ``attention.write_kv``: the reference's one-hot select;
  - ``attention.chunked_attention``: a copy of its kv head per q head
    where q's head dim is sharded past the kv heads;
  - ``attention._cache_contract`` (decode's scores and p @ v): each
    device contracts its own shards, a batch or head dim staying
    sharded and a summed sequence leaving a partial o, all-reduced; no
    operand is gathered (DTensor would gather p, and torch 2.11 the
    whole cache);
  - ``mamba._ssd_decode``: the SSM update sharded on heads over the
    model axis, as GSPMD shards it: local where the cache's heads are
    sharded (Mamba2), one all-gather of the new state into a cache
    whose head count the axis does not divide (Hymba's 25; GSPMD pads);
  - ``mamba.ssd_chunked`` on a sequence-sharded input: each device its
    own chunks, the intra-chunk form and the inter-chunk term
    contracted shard-locally; the chunk states and decays all-gathered
    once, the recurrence run on every device (DTensor gathered the
    intra-chunk scores and selected a chunk on a sharded dim at every
    step);
  - ``mamba._causal_conv`` on a sequence-sharded input: each shard after
    the k - 1 rows before it, a halo moved by a collective-permute
    (``permute_tensor``'s one-peer all-to-all, which the recorder names
    so), where DTensor all-to-all'ed the whole input;
  - ``mamba._conv_tail``: the cache's conv rows from the last shard's
    rows, gathered k - 1 a shard (DTensor gathered the whole input);
  - ``mamba._split_proj`` and ``mamba._split_conv``: decode's
    column-split in-projection output and its conv output each gathered
    on its channels once, not for each of the slices taken from it.
The decode step returns its logits replicated, the reference's out
sharding (``P()``): two all-gathers, vocab then batch
(``_replicated_logits``).  A norm's output gathered for several
projections moves once a step (``_redistributed_once``: the
compiler's common-subexpression pass leaves one all-gather).

Conventions against the reference's counts:
  - collective bytes are each payload's own, a bf16 collective at 2
    bytes an element, as an H100 would move it.  The reference's
    host-compiled HLO carries its collectives in f32 (XLA's CPU backend
    computes bf16 activations in f32), so the two are compared at one
    width, each floating payload of either side at 4 bytes an element
    (``collectives_at_f32``, the port's side; the records and their
    roofline keep the true bytes);
  - FLOPs: ``torch.utils.flop_counter``'s table, matmul-class ops only;
    XLA's cost analysis counts every op, so the port's FLOPs read lower
    and its ``useful_frac`` higher than the reference's on the same
    pair.  A convention, not a fault;
  - every collective's call site is kept (``coll_sites``: kind, op,
    dtype and shape, the innermost frames of the port), the counterpart
    of the HLO's ``op_name``, and every counted FLOP's (``flop_sites``:
    op and operand shapes).

The collectives depend on the torch version: DTensor 2.13 keeps a
flattened batch- and sequence-sharded tensor as a strided shard, older
versions replicate the sequence first, and 2.11's ``scatter`` rule
replicates every operand; the products and the scatter rule above take
those sites as 2.13 does (every record names its torch).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import itertools
import json
import math
import os
import re
import sys
import time
import traceback
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch.core import shardlib
from repro_torch.launch import roofline, sharding, steps
from repro_torch.launch.mesh import placeholder_mesh

__all__ = ["OUT_DIR", "build_lowered", "calibrated_costs",
           "collectives_at_f32", "lower_and_compile", "save_result", "main",
           "SCORE_BYTES_PER_ELEM", "fake_world", "torch_version_of"]

OUT_DIR = "experiments/dryrun_torch"


# ----------------------------------------------------------------------
# The fake world
# ----------------------------------------------------------------------
@contextlib.contextmanager
def fake_world(mesh):
    """A fake process group of ``mesh.size`` ranks (this process is rank
    0) and its ``DeviceMesh``; the group is destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run needs a process without a group")
    n = math.prod(mesh.shape.values())
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield init_device_mesh("cpu", tuple(mesh.shape.values()),
                               mesh_dim_names=tuple(mesh.axis_names))
    finally:
        dist.destroy_process_group()


def _local_shape(shape, placements, dmesh) -> tuple:
    """Device 0's shard shape: each sharded dim split in ``torch.chunk``'s
    way over its mesh dims in order, device 0 taking the first piece."""
    from torch.distributed.tensor import Shard
    out = list(shape)
    for mdim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = dmesh.shape[mdim]
            out[pl.dim] = -(-out[pl.dim] // n)
    return tuple(out)


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _distribute(tree, specs, dmesh, stats=None):
    """DTensors of fake zeros shaped like ``tree``'s (meta) leaves,
    placed by ``specs``; no collective.  ``stats["bytes"]`` sums the
    local shard bytes."""
    from torch.distributed.tensor import DTensor

    def one(leaf, spec):
        pl = shardlib.placements(spec, dmesh)
        local = _local_shape(tuple(leaf.shape), pl, dmesh)
        if stats is not None:
            stats["bytes"] += _nbytes(local, leaf.dtype)
        return DTensor.from_local(
            torch.zeros(local, dtype=leaf.dtype), dmesh, pl, run_check=False,
            shape=tuple(leaf.shape),
            stride=torch.empty(leaf.shape, device="meta").stride())
    return _map2(one, tree, specs)


def _map2(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree (specs are tuples,
    so the spec tree is walked by the data tree's structure)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map2(fn, getattr(tree, f.name), getattr(specs, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, v, s) for v, s in zip(tree, specs,
                                                          strict=True))
    return fn(tree, specs)


def local_bytes(tree, specs, mesh) -> int:
    """Summed local shard bytes of a (meta) tree placed by ``specs`` on
    ``mesh`` (device 0's shards; exact where the axes divide)."""
    total = [0]

    def one(leaf, spec):
        shp = list(leaf.shape)
        for dim, ax in enumerate(spec):
            for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
                shp[dim] = -(-shp[dim] // mesh.shape[a])
        total[0] += _nbytes(shp, leaf.dtype)
    _map2(one, tree, specs)
    return total[0]


# ----------------------------------------------------------------------
# The recorder
# ----------------------------------------------------------------------
def _is_shard(p) -> bool:
    """A ``Shard`` or a ``_StridedShard`` (not a subclass of ``Shard``)."""
    return not (p.is_replicate() or p.is_partial())


_UNEVEN = re.compile(r"not evenly divisible by mesh dimension (\d+)")


def _blocking_mesh_dim(msg: str, x):
    """The mesh dim whose sharding stops a view of ``x``, from DTensor's
    refusal: named where the message names it (a dim the axis does not
    divide); where it does not (torch 2.11's "unevenly sharded"), the
    mesh dim that shards a dim unevenly; else (a sharded dim flattened or
    split, which older DTensor refuses) the last mesh dim that shards;
    None if the error is another one."""
    placements = x.placements
    sharded = [i for i, p in enumerate(placements) if _is_shard(p)]
    m = _UNEVEN.search(msg)
    if m is not None:
        mdim = int(m.group(1))
    elif "unevenly sharded" in msg:
        mdim = next((i for i in sharded if x.shape[placements[i].dim]
                     % x.device_mesh.size(i)), None)
    elif "without redistribution" in msg:
        mdim = sharded[-1] if sharded else None
    else:
        return None
    if mdim is None or placements[mdim].is_replicate():
        return None
    return mdim


_VIEW_OPS = set()
_RETRIED = {}


def _replicate_dims(x, dims):
    """``x`` replicated on every mesh dim that shards one of ``dims``."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    pl = [Replicate() if _is_shard(p) and p.dim in dims else p
          for p in x.placements]
    return x if pl == list(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def _every_mesh_dim(out):
    """``out`` with one placement a mesh dim: a replicated DTensor that
    carries fewer (torch 2.11's ``constant_pad_nd`` rule on replicated
    operands) is replicated on every mesh dim; others as they are."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(out, DTensor) or \
            len(out.placements) == out.device_mesh.ndim:
        return out
    if not all(p.is_replicate() for p in out.placements):
        raise RuntimeError(f"{out.placements} on a {out.device_mesh.ndim}-D "
                           "mesh")
    return DTensor.from_local(
        out.to_local(), out.device_mesh,
        (Replicate(),) * out.device_mesh.ndim, run_check=False,
        shape=out.shape, stride=out.stride())


def _pad_args(args):
    # the input replicated whole
    x = args[0]
    return (_replicate_dims(x, range(x.ndim)),) + tuple(args[1:])


def _recorder_cls():
    from torch.distributed.tensor import DTensor, Replicate
    if not _VIEW_OPS:
        _VIEW_OPS.update((torch.ops.aten.view.default,
                          torch.ops.aten._unsafe_view.default,
                          torch.ops.aten.reshape.default))
        _RETRIED.update({torch.ops.aten.constant_pad_nd.default: _pad_args})
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry
    from torch.utils.weak import WeakIdKeyDictionary

    class _StepRecorder(TorchDispatchMode):
        """Counts device 0's local ops; DTensor ops are passed on
        (``NotImplemented``), so the mode sees what they desugar to."""

        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.coll = roofline.CollectiveRecorder()
            self.flop_sites = {}
            self.live = 0
            self.peak = 0
            self._storages = WeakIdKeyDictionary()
            self._nested = False
            self.view_replications = 0
            self.retries = 0

        def snapshot(self):
            """The counts so far, for ``restore`` to drop what a failed or
            superseded attempt added."""
            return (self.flops, self.bytes, dict(self.coll.bytes),
                    dict(self.coll.counts),
                    {k: list(v) for k, v in self.coll.sites.items()},
                    {k: list(v) for k, v in self.flop_sites.items()},
                    self.peak, self.view_replications)

        def restore(self, saved):
            (self.flops, self.bytes, self.coll.bytes, self.coll.counts,
             self.coll.sites, self.flop_sites, self.peak,
             self.view_replications) = saved

        def _pass_on(self, fn, *args, **kwargs):
            """``fn`` recorded, its DTensor ops left to DTensor."""
            self._nested = True
            try:
                with self:
                    return fn(*args, **kwargs)
            finally:
                self._nested = False

        def _bmm(self, a, b):
            """A bmm whose operands are both sharded on the batch dim
            alone (strided too: an einsum flattens a batch- and a
            head-sharded dim into it) runs shard by shard, as GSPMD runs
            it; DTensor would gather a strided batch first.  A replicated
            operand is split to the other's placement, without a
            collective."""
            target = []
            for pa, pb in zip(a.placements, b.placements, strict=True):
                if pa.is_replicate():
                    target.append(pb)
                elif (pb.is_replicate() or pa == pb) and _is_shard(pa):
                    target.append(pa)
                else:
                    target = None
                    break
            if target is None or not all(
                    p.is_replicate() or p.dim == 0 for p in target) \
                    or all(p.is_replicate() for p in target):
                return self._pass_on(torch.bmm, a, b)
            target = tuple(target)
            with self:
                if tuple(a.placements) != target:
                    a = a.redistribute(a.device_mesh, target)
                if tuple(b.placements) != target:
                    b = b.redistribute(b.device_mesh, target)
                local = torch.bmm(a.to_local(), b.to_local())
            shape = (a.shape[0], a.shape[1], b.shape[2])
            return DTensor.from_local(
                local, a.device_mesh, target, run_check=False, shape=shape,
                stride=(shape[1] * shape[2], shape[2], 1))

        def _softmax(self, x, dim, half_to_float):
            """softmax over a sharded dim as GSPMD takes it: the max
            all-reduced on its (small) result, then the sum likewise,
            where DTensor would gather the input (decode attention's
            scores over a sequence-sharded cache)."""
            d = dim % x.ndim
            if not any(_is_shard(p) and p.dim == d for p in x.placements):
                return self._pass_on(torch.ops.aten._softmax.default, x, dim,
                                     half_to_float)
            with self:
                e = torch.exp(x - torch.amax(x, dim=d, keepdim=True))
                return e / torch.sum(e, dim=d, keepdim=True)

        def _retried(self, func, args, kwargs):
            """An op whose DTensor rule, in some torch versions, plans no
            redistribution (``constant_pad_nd``) is taken again, when it
            fails, on operands replicated where ``_RETRIED`` says; the
            failed attempt's counts are dropped.
            A replicated output that a version's rule gives fewer
            placements than the mesh has dims is given one a mesh dim."""
            saved = self.snapshot()
            try:
                return _every_mesh_dim(self._pass_on(func, *args, **kwargs))
            except (RuntimeError, IndexError):
                pass
            self.restore(saved)
            self.retries += 1
            with self:
                args = _RETRIED[func](args)
            return _every_mesh_dim(self._pass_on(func, *args, **kwargs))

        def _logsumexp(self, x, dim, keepdim=False):
            """logsumexp over a sharded dim as GSPMD reduces it: a max and
            a sum, each all-reduced on its (small) result, where DTensor
            would gather the whole input (a vocab-sharded logits chunk)."""
            dims = [d % x.ndim for d in dim]
            if not any(_is_shard(p) and p.dim in dims
                       for p in x.placements):
                return self._pass_on(torch.logsumexp, x, dims, keepdim)
            with self:
                m = torch.amax(x, dim=dims, keepdim=True)
                total = torch.sum(torch.exp(x - m), dim=dims,
                                  keepdim=keepdim)
                return torch.log(total) + m.reshape(total.shape)

        def _view(self, func, args, kwargs):
            """A view DTensor cannot shard (a sharded dim split into
            factors its mesh axis does not divide) is taken after its
            input is replicated on that mesh axis, as GSPMD reshards at
            such a reshape; the redistribution is recorded."""
            x, rest = args[0], args[1:]
            relaid = False
            for _ in range(x.device_mesh.ndim + 2):
                try:
                    return self._pass_on(func, x, *rest, **kwargs)
                except (RuntimeError, ValueError) as e:
                    msg = str(e)
                    if "Cannot view a tensor" in msg and not relaid:
                        # a local shard laid out apart from its global
                        # tensor (after a redistribution): copied
                        # contiguous, as an eager reshape would copy it
                        relaid = True
                        with self:
                            x = DTensor.from_local(
                                x.to_local().contiguous(), x.device_mesh,
                                x.placements, run_check=False,
                                shape=x.shape, stride=x.stride())
                        continue
                    pl = list(x.placements)
                    mdim = _blocking_mesh_dim(msg, x)
                    if mdim is None:
                        raise
                    pl[mdim] = Replicate()
                self.view_replications += 1
                with self:
                    x = x.redistribute(x.device_mesh, pl)
            raise RuntimeError(f"{func} found no placement")

        def _free(self, n):
            self.live -= n

        def _track(self, t):
            st = t.untyped_storage()
            if st in self._storages:
                return
            n = st.nbytes()
            self._storages[st] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                if self._nested:
                    return NotImplemented
                if func in _VIEW_OPS:
                    return self._view(func, args, kwargs)
                if func is torch.ops.aten.bmm.default:
                    return self._bmm(*args)
                if func is torch.ops.aten._softmax.default:
                    return self._softmax(*args, **kwargs)
                if func is torch.ops.aten.logsumexp.default:
                    return self._logsumexp(*args, **kwargs)
                if func in _RETRIED:
                    return self._retried(func, args, kwargs)
                return NotImplemented
            out = func(*args, **kwargs)
            if _PAUSED:
                return out
            outs = [t for t in torch.utils._pytree.tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            for t in outs:
                self._track(t)
            if self.coll.add(func, out, args):
                return out
            packet = func._overloadpacket
            if packet in flop_registry:
                n = flop_registry[packet](*args, **kwargs, out_val=out)
                self.flops += n
                shapes = [list(t.shape) for t in args
                          if isinstance(t, torch.Tensor)]
                site = self.flop_sites.setdefault(
                    f"{packet.__name__} {shapes} @ {roofline.call_site(5)}",
                    [0, 0])
                site[0] += 1
                site[1] += n
            if not func.is_view:
                ins = [t for t in torch.utils._pytree.tree_leaves(
                    (args, kwargs)) if isinstance(t, torch.Tensor)]
                self.bytes += sum(t.numel() * t.element_size()
                                  for t in ins + outs)
            return out

    return _StepRecorder


@contextlib.contextmanager
def _local_products(rec):
    """``torch.einsum`` and ``x @ w`` (``w`` a matrix) of two DTensors
    that DTensor takes only after replicating a view (torch 2.11 refuses
    to flatten a batch- and a head- or sequence-sharded dim into one,
    which 2.13 keeps as a strided shard: attention's scores and p @ v,
    the MoE router's logits) taken again shard by shard (``_local_einsum``), the failed attempt's counts
    dropped; a product DTensor takes without one (every one on 2.13) is
    its own.  Patched on ``torch`` and ``torch.Tensor`` for the step's
    run (the checkpoint's recomputation in the backward, too)."""
    from torch.distributed.tensor import DTensor
    natives = {(torch, "einsum"): torch.einsum,
               (torch.Tensor, "__matmul__"): torch.Tensor.__matmul__}
    own = {key: key[1] in vars(key[0]) for key in natives}

    def equation(name, args):
        if name == "einsum":
            return args[0]
        x, w = args
        if w.ndim != 2 or x.ndim < 2:
            return None
        lead = "abcdefgh"[:x.ndim - 1]
        return f"{lead}y,yz->{lead}z"

    def retried(owner, name):
        native = natives[owner, name]

        def run(*args, **kwargs):
            ops = args[1:] if name == "einsum" else args
            if kwargs or len(ops) != 2 or not all(
                    isinstance(t, DTensor) for t in ops):
                return native(*args, **kwargs)
            saved = rec.snapshot()
            out = native(*args)
            eq = equation(name, args)
            if rec.view_replications == saved[-1] or eq is None:
                return out
            rec.restore(saved)
            local = _local_einsum(eq, *ops)
            if local is None:
                return native(*args)
            _took(name.strip("_"))
            return local
        return run
    for owner, name in natives:
        setattr(owner, name, retried(owner, name))
    try:
        yield
    finally:
        for (owner, name), fn in natives.items():
            if own[owner, name]:
                setattr(owner, name, fn)
            else:
                delattr(owner, name)


@contextlib.contextmanager
def _cpu_mesh_alltoall():
    """Shard(i) -> Shard(j) as the all-to-all a GPU mesh issues, where
    DTensor would all-gather and chunk on a CPU mesh."""
    from torch.distributed.tensor import _collective_utils, placement_types

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    mods = [m for m in (_collective_utils, placement_types)
            if hasattr(m, "shard_dim_alltoall")]
    saved = [m.shard_dim_alltoall for m in mods]
    for m in mods:
        m.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for m, f in zip(mods, saved, strict=True):
            m.shard_dim_alltoall = f


@contextlib.contextmanager
def _strided_shard_shapes():
    """``_StridedShard``'s shard-size helpers run outside every mode: they
    index an ``arange`` on the host, which ``FakeTensorMode`` cannot read
    back.  They compute shapes only, so nothing is left uncounted, and
    their results are kept: the same sizes recur at every layer."""
    import functools
    import inspect

    from torch.distributed.tensor import placement_types
    from torch.utils._python_dispatch import _disable_current_modes
    cls = getattr(placement_types, "_StridedShard", None)
    names = [n for n in ("local_shard_size_and_offset",
                         "_local_shard_size_and_offset")
             if cls is not None and n in vars(cls)]
    saved = {n: vars(cls)[n] for n in names}

    def unmoded(raw):
        kind = type(raw) if isinstance(raw, (staticmethod, classmethod)) \
            else None
        fn = raw.__func__ if kind else raw

        memo = {}

        @functools.wraps(fn)
        def run(*args, **kwargs):
            key = (args, tuple(sorted(kwargs.items())))
            try:
                return memo[key]
            except KeyError:
                pass
            except TypeError:           # an unhashable argument
                key = None
            with _disable_current_modes():
                out = fn(*args, **kwargs)
            if key is not None:
                memo[key] = out
            return out
        return kind(run) if kind else run

    for n in names:
        setattr(cls, n, unmoded(inspect.getattr_static(cls, n)))
    try:
        yield
    finally:
        for n, raw in saved.items():
            setattr(cls, n, raw)


@contextlib.contextmanager
def _mask_after_select():
    """A vocab-sharded ``gather`` followed by a select of its size-1 dim
    (``lm._ce_chunk``'s gold logit) reduces a partial whose output has
    one dim less than its mask; DTensor would index the mask as an
    embedding's.  The mask is reshaped to the output first."""
    try:
        from torch.distributed.tensor._ops._mask_buffer import MaskBuffer
    except ImportError:
        yield
        return
    orig = MaskBuffer.apply_mask

    def apply_mask(self, tensor):
        data = self.data
        if data is not None and data.ndim > tensor.ndim and \
                data.numel() == tensor.numel():
            tensor[data.reshape(tensor.shape)] = 0.0
            return
        orig(self, tensor)

    MaskBuffer.apply_mask = apply_mask
    try:
        yield
    finally:
        MaskBuffer.apply_mask = orig


_PAUSED = []


@contextlib.contextmanager
def _meta_propagation_unrecorded():
    """DTensor's sharding propagation runs ops of its own the first time
    it meets an op's schema: the op on fake global-shaped inputs to learn
    its output's shape, an op's decomposition to learn its strategy.
    Those runs are not the step's, so the recorder passes them by."""
    import functools

    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    names = [n for n in ("propagate_op_sharding_non_cached",
                         "_propagate_tensor_meta_non_cached",
                         "_propagate_tensor_meta")
             if n in vars(ShardingPropagator)]
    if not names:
        raise RuntimeError("DTensor's output-shape propagation not found")
    saved = {n: vars(ShardingPropagator)[n] for n in names}

    def paused(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            _PAUSED.append(1)
            try:
                return fn(*args, **kwargs)
            finally:
                _PAUSED.pop()
        return run

    for n, fn in saved.items():
        setattr(ShardingPropagator, n, paused(fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ShardingPropagator, n, fn)


def _plain_dense(x, w, b, activation, *, mode):
    # ``ops._dense_call`` on x's leading dims as they are (flattening a
    # batch- and sequence-sharded x into rows would give a strided shard,
    # split on the host at every op, or in older DTensor a gather), each
    # device contracting its own shards (``_local_einsum``) after
    # ``_dense_layout`` has placed the operands as GSPMD places them
    from torch.distributed.tensor import DTensor
    from repro_torch.kernels import ref
    _host_only(x)
    out = None
    placed = _dense_layout(x, w.to(x.dtype), mode, w) if isinstance(
        x, DTensor) and isinstance(w, DTensor) else None
    if placed is not None:
        lead = "abcdefgh"[:x.ndim - 1]
        xp, wp = placed
        if mode == "train":
            # x's gradient, a partial sum where the weight's columns are
            # split, reduced at once, as GSPMD reduces the transposed dot
            xp = _ReducedGrad.apply(xp)
        out = _local_einsum(f"{lead}y,yz->{lead}z", xp, wp)
    if out is None:
        return ref.dense_ref(x, w, b, activation=activation)
    _took("_dense_call")
    # a contraction over a sharded dim leaves each shard a partial sum,
    # all-reduced at once, as GSPMD reduces it, where DTensor would carry
    # it into the residual stream (and reduce it again, in f32, at every
    # later norm, or reduce-scatter it at the block's constraint); in
    # training its gradient is gathered whole, as the transpose of
    # GSPMD's all-reduce gathers it
    out = _reduced(out)
    if b is not None:
        out = out + b.to(out.dtype)
    if activation == "relu":
        out = torch.relu(out)
    elif activation != "none":
        raise ValueError(activation)
    return out


def _dense_layout(x, w, mode, w_own=None):
    """x and w of a dense placed as GSPMD places a dot's operands, on
    each mesh dim (``w_own``: the weight before its cast, which
    ``_head_laid_products`` may have marked):
      - in training, x sharded on its sequence and w on its columns, the
        product laid out next on those columns with no op between (v's
        projection into its head constraint; q's and k's are roped
        first), as ``_head_laid_products`` marks it: x is gathered over
        its sequence and w stays (GSPMD propagates the constraint back
        into the dot), so the product leaves column-sharded; x's
        gradient, a partial sum over the columns, is all-reduced at once
        and sliced back, and w's stays on its shard.  The reference's
        HLO gathers x there (its stack frames: ``dense(params["wv"]``)
        for every arch whose kv heads the model axis divides, Phi-3's and
        Gemma-2's included, and gathers the weights of q, k and the MLP;
      - x sharded on a leading dim (batch, sequence) and w sharded: the
        weight is gathered and x stays where it is (DTensor would gather
        x, once per projection and again in the remat); its gradient is
        reduce-scattered back to its shard;
      - x's contraction split (sharded, or a partial sum) where w's
        output is sharded (the encoder-decoder's residual stream, which
        no block constraint lays out): x is gathered or reduced, and the
        product runs column-parallel (DTensor would move the weight and
        reduce-scatter the product, the MLP's whole hidden);
      - in prefill and training, x replicated on the model axis and w
        sharded on its rows (the attention output of a head count the
        axis does not divide, into ``wo``): x's sequence is sliced
        locally and the weight gathered, so the output leaves
        sequence-sharded, as the residual stream and Hymba's mixer
        branch lie (DTensor would slice the contraction, a partial sum
        all-reduced at the next norm; a batch-sliced x left Hymba's
        attention branch batch-sharded, all-to-all'ed against the
        mixer's at ``blocks._hybrid_mix``, forward and backward).  In
        training x's gradient, sequence-sharded, is gathered by the
        attention's backward, which runs whole on every device, as the
        reference's does;
      - in decode, x and the weight both replicated on the model axis
        (the mamba mixer's; DTensor would run it whole on every device),
        the product split as the reference's propagation splits it: a
        widening weight (``in_proj``, whose slices feed the
        channel-sharded conv and the heads-sharded SSD) on its output
        columns, the reference's dot f32[64,2192] for Mamba2's [1024,4384]
        and f32[64,3229] for Hymba's (uneven, 6457 columns); a narrowing
        one (``out_proj``, into the replicated residual stream) on its
        contraction, locally, and reduced, the reference's [64,1600] x
        [1600,1600] and all-reduce for Hymba.
    Gathers come first (x's once a step), then local slices, whose
    gradients stay sliced (``_split_locally``)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    rules = shardlib.get_rules() or {}
    tp = mesh.mesh_dim_names.index(rules["tp"]) if "tp" in rules else None
    xp, wp = list(x.placements), list(w.placements)
    direct = bool(_RUNS) and id(w_own) in _RUNS[-1].direct
    for m, n in enumerate(mesh.shape):
        if direct and xp[m].is_shard(x.ndim - 2) and wp[m].is_shard(1):
            xp[m] = Replicate()
        elif _is_shard(xp[m]) and xp[m].dim != x.ndim - 1:
            if not wp[m].is_replicate():
                wp[m] = Replicate()
        elif not xp[m].is_replicate() and wp[m].is_shard(1):
            xp[m] = Replicate()
        elif m != tp or not xp[m].is_replicate():
            continue
        elif mode != "decode" and wp[m].is_shard(0) and x.ndim >= 3 and \
                x.shape[-2] % n == 0:
            xp[m], wp[m] = Shard(x.ndim - 2), Replicate()
        elif mode == "decode" and wp[m].is_replicate() and \
                w.shape[1] > w.shape[0]:
            wp[m] = Shard(1)
        elif mode == "decode" and wp[m].is_replicate() and \
                x.shape[-1] % n == 0:
            xp[m], wp[m] = Shard(x.ndim - 1), Shard(0)
    return _placed(x, xp), _placed(w, wp)


def _placed(t, placements):
    """``t`` on ``placements``: first gathered (or reduced) where they
    replicate what ``t`` splits, once a step for each tensor
    (``_redistributed_once``; the backward reduce-scatters), then split
    locally where they shard what ``t`` replicates."""
    from torch.distributed.tensor import Replicate
    whole = [Replicate() if q.is_replicate() else p
             for p, q in zip(t.placements, placements, strict=True)]
    return _split_locally(_redistributed_once(t, whole), placements)


@dataclasses.dataclass
class _Run:
    """The state of one step's run under ``_sharded_model_paths``: the
    redistributions already made (``_redistributed_once``), for each
    swapped name how many calls took the dry-run's own path (``_took``),
    the step's mode and the weights whose product goes straight to its
    head constraint (``direct``: ``_head_laid_products``)."""
    memo: object
    taken: dict
    mode: str = "train"
    direct: set = dataclasses.field(default_factory=set)


_RUNS = []


def _took(name):
    """Counts a call of the swapped ``name`` that took the dry-run's own
    path (not the model's, which it falls back to where the placements
    need none)."""
    if _RUNS:
        _RUNS[-1].taken[name] = _RUNS[-1].taken.get(name, 0) + 1


def _redistributed_once(x, placements):
    """``x`` redistributed to ``placements``, once a step for each
    tensor and target (a norm's output gathered for q, k and v moves
    once, as the compiler's common-subexpression pass leaves one
    all-gather); ``_sharded_model_paths`` holds the step's memo."""
    if placements == list(x.placements):
        return x
    memo = _RUNS[-1].memo if _RUNS else {}
    seen = memo.setdefault(x, {})
    key = tuple(placements)
    if key not in seen:
        seen[key] = x.redistribute(x.device_mesh, placements)
    return seen[key]


def _reduced(t):
    """``t`` with every partial placement reduced (all-reduced), the
    others kept; a plain tensor as it is."""
    from torch.distributed.tensor import Replicate
    old = list(getattr(t, "placements", ()))
    pl = [Replicate() if p.is_partial() else p for p in old]
    return t if pl == old else t.redistribute(t.device_mesh, pl)


def _plain_rmsnorm(x, scale, eps: float = 1e-6):
    # ``ops.rmsnorm`` on x's leading dims, for the same reason
    from repro_torch.kernels import ref
    _host_only(x)
    _took("rmsnorm")
    return ref.rmsnorm_ref(x, scale, eps=eps)


def _one_hot_write_kv(ck, cv, k, v, lens):
    # ``attention.write_kv`` as the reference's one-hot select, copied
    # back in place: DTensor has no rule for an index_put on sharded rows
    _host_only(ck)
    _took("write_kv")
    S = ck.shape[1]
    write = (torch.arange(S)[None, :] == lens[:, None])[:, :, None, None]
    ck.copy_(torch.where(write, k.to(ck.dtype), ck))
    cv.copy_(torch.where(write, v.to(cv.dtype), cv))


def _head_split_attention(orig):
    # ``attention.chunked_attention`` with a q whose head dim is sharded
    # more ways than there are kv heads: it cannot be grouped (KH, G)
    # where it lies, so each q head takes its own copy of its kv head
    import functools

    @functools.wraps(orig)
    def run(q, k, v, **kwargs):
        ways = math.prod(q.device_mesh.size(m) for m, p in enumerate(
            q.placements) if p.is_shard(2)) if hasattr(q, "placements") \
            else 1
        if k.shape[2] % ways:
            _took("chunked_attention")
            k, v = (t.repeat_interleave(q.shape[2] // t.shape[2], dim=2)
                    for t in (k, v))
        return orig(q, k, v, **kwargs)
    return run


def _vocab_parallel_embed(params, tokens):
    # ``layers.embed`` as GSPMD shards it: over a vocab-sharded table each
    # shard looks up the rows in its own range and zeros elsewhere (the
    # masked partial of DTensor's ``aten.embedding`` rule, which
    # ``index_select`` lacks: it would move the table), and the rows are
    # all-reduced once, before the cast, as the reference's decode step
    # all-reduces them; the caller's own constraint then takes its slice
    # locally.  The table never moves.  Their gradient is reduced whole
    # before the lookup's backward (a partial one, from a product that
    # splits them, has no redistribution to the masked partial)
    _host_only(tokens)
    _took("embed")
    return _ReducedGrad.apply(_reduced(F.embedding(tokens,
                                                   params["table"])))


class _ReducedGrad(torch.autograd.Function):
    """The identity, its gradient's partial sums reduced (all-reduced)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _reduced(grad)


def _contiguous(shape) -> tuple:
    """A contiguous tensor's strides for ``shape``, computed (an empty
    meta tensor would be an op the recorder counts, at the global
    shape)."""
    return tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))


def _local_einsum(eq, a, b, dtype=None):
    # ``torch.einsum`` of two DTensors as GSPMD partitions a dot: each
    # device contracts its own shards, with no operand gathered.  On each
    # mesh dim an operand's sharded letter splits the other operand where
    # it holds it (locally); a letter kept in the output stays sharded, one
    # summed leaves a partial sum (the caller reduces it, or DTensor at
    # the next op that needs it).  An operand replicated on a mesh dim
    # where the other is split takes its gradient as a partial sum there.
    # ``dtype``: the local operands cast to it.  None where an operand is
    # not a DTensor, a placement is not a plain shard or the two shard one
    # mesh dim on two letters: DTensor has to move one first
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)) or any(
            not (p.is_replicate() or type(p) is Shard)
            for p in a.placements + b.placements):
        return None
    (la, lb), lo = eq.split("->")[0].split(","), eq.split("->")[1]
    letters = [{la[pa.dim] if pa.is_shard() else None,
                lb[pb.dim] if pb.is_shard() else None} - {None}
               for pa, pb in zip(a.placements, b.placements)]
    if any(len(xs) > 1 for xs in letters):
        return None
    to_a, to_b, ga, gb, out = [], [], [], [], []
    for xs in letters:
        x = min(xs, default=None)
        to_a.append(Shard(la.index(x)) if x and x in la else Replicate())
        to_b.append(Shard(lb.index(x)) if x and x in lb else Replicate())
        ga.append(Partial() if x and x not in la else to_a[-1])
        gb.append(Partial() if x and x not in lb else to_b[-1])
        out.append(Replicate() if x is None else
                   Shard(lo.index(x)) if x in lo else Partial())
    a, b = (_split_locally(t, pl) for t, pl in ((a, to_a), (b, to_b)))
    size = dict(zip(la, a.shape)) | dict(zip(lb, b.shape))
    shape = tuple(size[c] for c in lo)
    al, bl = a.to_local(grad_placements=ga), b.to_local(grad_placements=gb)
    if dtype is not None:
        al, bl = al.to(dtype), bl.to(dtype)
    return DTensor.from_local(
        torch.einsum(eq, al, bl), a.device_mesh, out, run_check=False,
        shape=shape, stride=_contiguous(shape))


class _LocalSplit(torch.autograd.Function):
    """A replicated DTensor split to shards where it is (no collective),
    its gradient passed on sharded, as DTensor's own ops pass an
    operand's on (a redistribution's backward would gather it)."""

    @staticmethod
    def forward(ctx, t, placements):
        return t.redistribute(t.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _split_locally(t, placements):
    """``t`` on ``placements``, each a shard where ``t`` is replicated or
    the placement it has; the same placements: ``t`` itself (a
    redistribution there would reduce a partial gradient whole)."""
    if list(t.placements) == list(placements):
        return t
    return _LocalSplit.apply(t, tuple(placements))


def _local_contract(eq, a, b):
    # ``attention._cache_contract`` as GSPMD partitions a dot
    # (``_local_einsum``), in f32, a partial sum reduced at once (the
    # sequence of a sequence-sharded cache: p @ v).  DTensor's einsum
    # would flatten the batch- and head-sharded dims (which torch 2.11
    # refuses: the whole cache gathered) and gather a sequence-sharded p
    _host_only(a)
    out = _local_einsum(eq, a, b, dtype=torch.float32)
    if out is None:
        # a plain tensor, or placements DTensor has to move first
        return torch.einsum(eq, a.float(), b.float())
    _took("_cache_contract")
    return _reduced(out)


def _heads_sharded_ssd(ssm, dt, A, xs, Bv, Cv, D):
    # ``mamba._ssd_decode`` sharded on heads over the model axis, as GSPMD
    # shards it, a head count the axis does not divide too (GSPMD pads
    # it): the state a local slice of the cache, and the caller's copy
    # back into the cache local where the cache's heads are sharded, an
    # all-gather where they are not.  y is a product and a sum, which an
    # uneven heads shard allows (the einsum would flatten the heads)
    from torch.distributed.tensor import DTensor, Shard
    _host_only(ssm)
    _took("_ssd_decode")

    def heads(t):
        if not isinstance(t, DTensor):
            return t
        pl = list(t.placements)
        mdim = t.device_mesh.mesh_dim_names.index(shardlib.get_rules()["tp"])
        if not pl[mdim].is_replicate():
            return t
        pl[mdim] = Shard(1)
        return t.redistribute(t.device_mesh, pl)
    ssm, dt, xs = heads(ssm), heads(dt), heads(xs)
    dA = torch.exp(dt * A)
    state = ssm * dA[..., None, None] + \
        (dt[:, :, None] * xs)[..., None] * Bv[:, None, None, :]
    y = (state * Cv[:, None, None, :]).sum(-1) + xs * D[:, None]
    return state, y


def _sequence_mesh_dim(x, divisor: int = 1):
    """The mesh dim that shards x's sequence (dim 1) where x is sharded
    on its batch (dim 0) and on that one mesh dim only, in shards of a
    multiple of ``divisor`` rows; else None."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor) or not all(
            p.is_replicate() or (type(p) is Shard and p.dim < 2)
            for p in x.placements):
        return None
    dims = [m for m, p in enumerate(x.placements) if p.is_shard(1)]
    if len(dims) != 1 or x.shape[1] % (x.device_mesh.size(dims[0])
                                       * divisor):
        return None
    return dims[0]


def _grad_partial(t, x):
    """The local tensor of ``t``, a DTensor replicated where x is sharded
    (a weight), its gradient a partial sum on every mesh dim that shards
    x; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Partial
    if not isinstance(t, DTensor):
        return t
    return t.to_local(grad_placements=[
        Partial() if _is_shard(px) else p
        for p, px in zip(t.placements, x.placements, strict=True)])


def _like(local, x, shape, dims=()):
    """``local`` as a DTensor on x's mesh, sharded as x is on its batch
    and on ``dims``, replicated elsewhere."""
    from torch.distributed.tensor import DTensor, Replicate
    pl = [p if _is_shard(p) and (p.dim == 0 or p.dim in dims) else
          Replicate() for p in x.placements]
    return DTensor.from_local(local, x.device_mesh, pl, run_check=False,
                              shape=shape, stride=_contiguous(shape))


def _gathered_on(local, x, m):
    """The per-shard tensors ``local`` (b, n_local, ...) of every shard of
    x's sequence along mesh dim ``m``, concatenated on dim 1 in sequence
    order: one all-gather, its gradient reduce-scattered back."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    n = x.device_mesh.size(m)
    pl = [Shard(1) if i == m else p for i, p in enumerate(x.placements)]
    shape = (x.shape[0], local.shape[1] * n, *local.shape[2:])
    t = _like(local, x, shape, dims=(1,))
    t = t.redistribute(x.device_mesh, [Replicate() if i == m else p
                                       for i, p in enumerate(pl)])
    return t.to_local(grad_placements=[Partial() if i == m else p
                                       for i, p in enumerate(t.placements)])


def _sequence_sharded_ssd(orig):
    # ``mamba.ssd_chunked`` on a sequence-sharded input as GSPMD runs it:
    # each device the chunk terms of its own chunks
    # (``mamba.ssd_chunk_terms``), no operand gathered (DTensor would
    # gather the intra-chunk scores and select a chunk on a sharded dim at
    # every step of the recurrence); the chunk states and decays
    # all-gathered once, the recurrence (``mamba.ssd_chunk_output``) run
    # on every device
    from repro_torch.models import mamba

    @functools.wraps(orig)
    def run(x, dt, A, B, C, D, chunk: int = 256,
            return_final_state: bool = False):
        _host_only(x)
        Q = min(chunk, x.shape[1])
        m = _sequence_mesh_dim(x, Q)
        if m is None:
            return orig(x, dt, A, B, C, D, chunk=chunk,
                        return_final_state=return_final_state)
        _took("ssd_chunked")
        mesh, n = x.device_mesh, x.device_mesh.size(m)
        dt, B, C = (t.redistribute(mesh, x.placements) for t in (dt, B, C))
        xl = x.to_local()
        terms = mamba.ssd_chunk_terms(xl, dt.to_local(), _grad_partial(A, x),
                                      B.to_local(), C.to_local(), Q)
        y, state = mamba.ssd_chunk_output(
            xl, _grad_partial(D, x), terms,
            _gathered_on(terms.states, x, m), _gathered_on(terms.decays, x, m),
            mesh.get_local_rank(m) * (x.shape[1] // n // Q))
        y = _like(y, x, x.shape, dims=(1,))
        if not return_final_state:
            return y
        return y, _like(state, x, (x.shape[0], *state.shape[1:]))
    return run


def _previous_rows(rows, x, m):
    """Each shard of x's sequence along mesh dim ``m`` receives the
    previous shard's ``rows`` (the first receives zeros): one
    collective-permute (``all_to_all_single`` to one peer, from one),
    differentiable."""
    import torch.distributed._functional_collectives as funcol
    mesh = x.device_mesh
    n, r = mesh.size(m), mesh.get_local_rank(m)
    send, recv = [0] * n, [0] * n
    send[(r + 1) % n] = recv[(r - 1) % n] = rows.numel()
    got = funcol.all_to_all_single_autograd(
        rows.reshape(-1), recv, send, mesh.get_group(m)).reshape(rows.shape)
    return got if r else got * 0


def _halo_conv(orig):
    # ``mamba._causal_conv`` on a sequence-sharded input: each shard
    # convolves its own rows after the k - 1 rows before them, a halo
    # moved by a collective-permute, as GSPMD moves it (DTensor would
    # all-to-all the whole input)
    @functools.wraps(orig)
    def run(x, w, b):
        _host_only(x)
        k = w.shape[0]
        m = _sequence_mesh_dim(x)
        if m is None or x.shape[1] // x.device_mesh.size(m) < k - 1:
            return orig(x, w, b)
        _took("_causal_conv")
        xl = x.to_local()
        halo = _previous_rows(xl[:, xl.shape[1] - (k - 1):], x, m)
        out = orig(xl, _grad_partial(w, x), _grad_partial(b, x), halo)
        return _like(out, x, x.shape, dims=(1,))
    return run


def _last_shard_tail(orig):
    # ``mamba._conv_tail`` on a sequence-sharded input: the last shard's
    # last k - 1 rows, each shard's gathered (k - 1 rows a shard), where
    # DTensor would gather the whole input
    @functools.wraps(orig)
    def run(conv_in, k, dtype):
        _host_only(conv_in)
        m = _sequence_mesh_dim(conv_in)
        if m is None or conv_in.shape[1] // conv_in.device_mesh.size(m) \
                < k - 1:
            return orig(conv_in, k, dtype)
        _took("_conv_tail")
        local = conv_in.to_local()
        rows = _gathered_on(local[:, local.shape[1] - (k - 1):].to(dtype),
                            conv_in, m)
        return _like(rows[:, rows.shape[1] - (k - 1):], conv_in,
                     (conv_in.shape[0], k - 1, conv_in.shape[2]))
    return run


def _realigned(t, m, a, b):
    """Columns [a, b) of ``t``, sharded on its last dim over mesh dim
    ``m`` (``torch.chunk``'s layout), sharded evenly on their own last
    dim over ``m``, as GSPMD partitions a slice: each device keeps the
    columns of its new shard it holds and receives the rest, one
    collective-permute for each peer offset that moves any (a one-peer
    ``all_to_all_single``), its payload the largest any device receives
    at that offset (a permute's buffer is one shape on every device)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Shard
    mesh = t.device_mesh
    n, r = mesh.size(m), mesh.get_local_rank(m)
    W, L = t.shape[-1], b - a

    def span(q, lo, size):
        # device q's columns of [lo, lo + size) in ``torch.chunk``'s layout
        step = -(-size // n)
        return lo + min(q * step, size), lo + min((q + 1) * step, size)

    def overlap(q, p):
        # the columns device q's new shard takes from device p's old one
        (lo, hi), (plo, phi) = span(q, a, L), span(p, 0, W)
        lo = max(lo, plo)
        return lo, max(min(hi, phi), lo)
    local, got = t.to_local(), {}
    start, rows = span(r, 0, W)[0], math.prod(local.shape[:-1])
    for d in range(1, n):
        size = max(hi - lo for lo, hi in (overlap(q, (q - d) % n)
                                          for q in range(n)))
        if not size:
            continue
        to, frm = (r + d) % n, (r - d) % n
        lo, hi = overlap(to, r)
        send = F.pad(local[..., lo - start:hi - start], (0, size - (hi - lo)))
        send_n, recv_n = [0] * n, [0] * n
        send_n[to] = recv_n[frm] = rows * size
        buf = funcol.all_to_all_single(
            send.movedim(-1, 0).reshape(-1), recv_n, send_n,
            mesh.get_group(m)).reshape(size, *local.shape[:-1])
        lo, hi = overlap(r, frm)
        got[frm] = buf.movedim(0, -1)[..., :hi - lo]
    lo, hi = overlap(r, r)
    got[r] = local[..., lo - start:hi - start]
    # the new shard's columns come from devices in increasing order
    pieces = [got[p] for p in range(n) if p in got]
    pl = [Shard(t.ndim - 1) if i == m else p
          for i, p in enumerate(t.placements)]
    shape = (*t.shape[:-1], L)
    return DTensor.from_local(torch.cat(pieces, dim=-1), mesh, pl,
                              run_check=False, shape=shape,
                              stride=_contiguous(shape))


def _realigned_slices(orig):
    # ``mamba._split_proj`` and ``mamba._split_conv``: decode's
    # column-split in-projection output and the conv's channel-sharded
    # output, each slice realigned to an even shard of its own channels
    # (``_realigned``), as the reference's HLO realigns them by
    # collective-permutes, where DTensor would gather the whole tensor
    # for each of the slices taken from it
    @functools.wraps(orig)
    def run(t, H, P, N):
        _host_only(t)
        m = next((i for i, p in enumerate(getattr(t, "placements", ()))
                  if p.is_shard(t.ndim - 1)), None)
        if m is None or any(_is_shard(p) and p.dim != 0 for i, p in
                            enumerate(t.placements) if i != m):
            return orig(t, H, P, N)
        _took(orig.__name__)
        ends = [0] + [int(x.shape[-1]) for x in orig(
            torch.empty((0, t.shape[-1]), device="meta"), H, P, N)]
        bounds = list(itertools.accumulate(ends))
        return tuple(_realigned(t, m, lo, hi)
                     for lo, hi in zip(bounds, bounds[1:]))
    return run


class _Constraint(torch.autograd.Function):
    """``shardlib``'s constraint as the reference's
    ``with_sharding_constraint`` is differentiated: x laid out on the
    placements, and its gradient laid out on them too (the constraint's
    transpose), where DTensor's redistribution would send the gradient
    back to x's own placements, or leave it as it comes where x already
    lies so."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        if tuple(x.placements) == placements:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) == ctx.placements:
            return grad, None
        return grad.redistribute(grad.device_mesh, ctx.placements), None


def _transposed_constraint(x, spec):
    # ``shardlib._redistribute`` through ``_Constraint`` (training only:
    # its gradient); a plain tensor as it is
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = shardlib.placements(spec, x.device_mesh)
    if not x.requires_grad:
        return x if tuple(x.placements) == want else \
            x.redistribute(x.device_mesh, want)
    return _Constraint.apply(x, want)


def _reduced_grads(orig):
    # ``steps.value_and_grad``: the model's own, each gradient that is a
    # partial sum (a replicated weight's, the batch split) all-reduced
    # once as it leaves the backward, as GSPMD reduces it there; DTensor
    # carries it into the optimizer and reduces it at each op that needs
    # it whole (the global norm and the second moment, and on torch 2.11
    # the first moment too)
    from repro_torch.core.tree import tree_map

    @functools.wraps(orig)
    def run(loss_fn, params, batch):
        out, grads = orig(loss_fn, params, batch)
        return out, tree_map(_reduced, grads)
    return run


def _head_laid_products(orig):
    # ``attention.project_qkv``: the projections whose products go
    # straight to their head constraint, with no op between (v; in
    # cross-attention, which ropes neither, q and k too, unless a qk norm
    # comes first), are marked for ``_dense_layout``, which takes them
    # column-parallel in training, as GSPMD propagates the constraint
    # back into the dot: x gathered over its sequence, the weight kept on
    # its columns.  q and k, roped first, keep the weight gathered
    @functools.wraps(orig)
    def run(params, x, positions, cfg, kv_source=None):
        rules = shardlib.get_rules() or {}
        if not _RUNS or _RUNS[-1].mode != "train" or cfg.attn_kv_gather \
                or rules.get("tp") is None:
            return orig(params, x, positions, cfg, kv_source)
        names = [n for n, axis in (("wv", "kv_heads"), ("wk", "kv_heads"),
                                   ("wq", "heads"))
                 if rules.get(axis) == rules["tp"] and (n == "wv" or (
                     kv_source is not None and not cfg.qk_norm))]
        if names:
            _took("project_qkv")
        marks = {id(params[n]["w"]) for n in names}
        direct = _RUNS[-1].direct
        direct |= marks
        try:
            return orig(params, x, positions, cfg, kv_source)
        finally:
            direct -= marks
    return run


def _vocab_sharded_ce(orig):
    # ``lm._ce_chunk`` with a head table the model axis does not divide
    # (Hymba's 32001 rows, InternVL2's 92553; left replicated by the
    # param specs): the table is split on its rows where it lies, as
    # GSPMD pads and splits it, so the logits come out vocab-sharded from
    # the product and stay so in the backward; the hidden's gradient is a
    # partial sum, reduced once.  DTensor would slice the replicated
    # logits at their vocab constraint and gather their gradient whole
    @functools.wraps(orig)
    def run(h, lbl, table, cap):
        from torch.distributed.tensor import DTensor, Shard
        _host_only(h)
        rules = shardlib.get_rules() or {}
        if not isinstance(table, DTensor) or rules.get("vocab") is None:
            return orig(h, lbl, table, cap)
        m = table.device_mesh.mesh_dim_names.index(rules["vocab"])
        pl = list(table.placements)
        if not pl[m].is_replicate():
            return orig(h, lbl, table, cap)
        _took("_ce_chunk")
        pl[m] = Shard(0)
        return orig(h, lbl, _split_locally(table, pl), cap)
    return run


def _host_only(x):
    if x.device.type != "cpu":
        raise NotImplementedError(
            "the dry-run's model paths take the dry-run's fake CPU shards "
            f"only, not a tensor on {x.device}")


@contextlib.contextmanager
def _sharded_model_paths(mode: str = "train"):
    """The model functions DTensor cannot take as the card and CPU paths
    write them, replaced for the step's run by the dry-run's own
    (listed in the module's docstring; ``mode``: the step's, ``train``,
    ``prefill`` or ``decode``); restored on exit."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention, encdec, layers, lm, mamba
    swaps = [(ops, "_dense_call", functools.partial(_plain_dense,
                                                     mode=mode)),
             (ops, "rmsnorm", _plain_rmsnorm),
             (attention, "write_kv", _one_hot_write_kv),
             (attention, "chunked_attention",
              _head_split_attention(attention.chunked_attention)),
             (attention, "_cache_contract", _local_contract),
             (attention, "project_qkv",
              _head_laid_products(attention.project_qkv)),
             (mamba, "_ssd_decode", _heads_sharded_ssd),
             (mamba, "ssd_chunked", _sequence_sharded_ssd(mamba.ssd_chunked)),
             (mamba, "_causal_conv", _halo_conv(mamba._causal_conv)),
             (mamba, "_conv_tail", _last_shard_tail(mamba._conv_tail)),
             (mamba, "_split_proj", _realigned_slices(mamba._split_proj)),
             (mamba, "_split_conv", _realigned_slices(mamba._split_conv)),
             (lm, "_ce_chunk", _vocab_sharded_ce(lm._ce_chunk))]
    # the callers' own names: ``lm`` and ``encdec`` import ``embed``
    swaps += [(mod, "embed", _vocab_parallel_embed)
              for mod in (layers, lm, encdec)]
    if mode == "train":
        swaps += [(shardlib, "_redistribute", _transposed_constraint),
                  (steps, "value_and_grad",
                   _reduced_grads(steps.value_and_grad))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    from torch.utils.weak import WeakIdKeyDictionary
    run = _Run(memo=WeakIdKeyDictionary(), taken={}, mode=mode)
    _RUNS.append(run)
    try:
        yield run
    finally:
        _RUNS.pop()
        for mod, name, fn in saved:
            setattr(mod, name, fn)


_RULES_REGISTERED = []


def _sharding_rules():
    """Sharding strategies for the ops DTensor has none for (each listed
    in the module's docstring); registered once per process."""
    if _RULES_REGISTERED:
        return
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.searchsorted.Tensor)
    def _searchsorted(sorted_seq, values, *args, **kwargs):
        # every operand replicated: the sorted expert ids are gathered
        return [([Replicate()], [Replicate(), Replicate(), None])]
    _RULES_REGISTERED.append(_searchsorted)

    @register_sharding(torch.ops.aten.scatter.src)
    def _scatter(x, dim, index, src):
        # sharded on any dim but the scattered one where every operand
        # has x's size (the MoE dispatch's buffer, sharded on its batch),
        # or replicated: torch 2.13's own rule, which 2.11 lacks (it
        # gathered the dispatch's index and copies whole)
        d = dim % x.ndim
        return [([Replicate()], [Replicate(), None, Replicate(),
                                 Replicate()])] + [
            ([Shard(i)], [Shard(i), None, Shard(i), Shard(i)])
            for i in range(x.ndim) if i != d and index.ndim == x.ndim
            and x.shape[i] == index.shape[i] == src.shape[i]]
    _RULES_REGISTERED.append(_scatter)

    if _has_no_rule(torch.ops.aten.flip.default):
        @register_sharding(torch.ops.aten.flip.default)
        def _flip(x, dims):
            # sharded on any dim it does not reverse, or partial, as is
            rev = {d % x.ndim for d in dims}
            return [([Replicate()], [Replicate(), None]),
                    ([Partial()], [Partial(), None])] + [
                ([Shard(d)], [Shard(d), None])
                for d in range(x.ndim) if d not in rev]
        _RULES_REGISTERED.append(_flip)

    if _has_no_rule(torch.ops.aten.detach_.default):
        # the placements kept, as the version's rule for aten.detach
        from torch.distributed.tensor import DTensor
        prop = DTensor._op_dispatcher.sharding_propagator
        like = torch.ops.aten.detach.default
        prop.register_op_strategy(torch.ops.aten.detach_.default,
                                  prop.op_strategy_funcs[like],
                                  prop.op_to_schema_info.get(like))
        _RULES_REGISTERED.append(torch.ops.aten.detach_.default)


def _has_no_rule(op) -> bool:
    """Whether this torch's DTensor has no sharding rule for ``op``."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    return not any(op in t for t in (getattr(prop, a, None) for a in (
        "op_to_rules", "op_strategy_funcs", "op_single_dim_strategy_funcs"))
        if isinstance(t, dict))


# ----------------------------------------------------------------------
# Lowering
# ----------------------------------------------------------------------
@dataclasses.dataclass
class LoweredStep:
    """One step ready to run: the step function and its DTensor inputs."""
    fn: object
    args: tuple
    argument_bytes: int
    rules: dict
    mode: str = "train"

    def compile(self) -> "CompiledStep":
        """Run the step once under the recorder (the counterpart of
        ``Lowered.compile``): returns its recorded costs."""
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch.models import attention
        rec = _recorder_cls()()
        attention.reset_block_skips()
        with shardlib.rules_scope(self.rules), implicit_replication(), \
                _cpu_mesh_alltoall(), _strided_shard_shapes(), \
                _mask_after_select(), _meta_propagation_unrecorded(), \
                _sharded_model_paths(self.mode) as run, rec, \
                _local_products(rec):
            out = self.fn(*self.args)
            out_bytes = sum(_local(t).numel() * _local(t).element_size()
                            for t in _tensor_leaves(out))
        return CompiledStep(flops=float(rec.flops), bytes=float(rec.bytes),
                            coll=rec.coll.result(), temp=float(rec.peak),
                            argument_bytes=float(self.argument_bytes),
                            output_bytes=float(out_bytes),
                            block_skips=attention.BLOCK_SKIPS["skipped"],
                            view_replications=rec.view_replications,
                            retries=rec.retries, coll_sites=rec.coll.sites,
                            flop_sites=rec.flop_sites, swaps=run.taken)


@dataclasses.dataclass
class CompiledStep:
    flops: float
    bytes: float
    coll: dict
    temp: float
    argument_bytes: float
    output_bytes: float
    block_skips: int = 0
    view_replications: int = 0
    retries: int = 0
    coll_sites: dict = dataclasses.field(default_factory=dict)
    flop_sites: dict = dataclasses.field(default_factory=dict)
    swaps: dict = dataclasses.field(default_factory=dict)

    def memory_analysis(self) -> dict:
        return {"temp_size_in_bytes": self.temp,
                "argument_size_in_bytes": self.argument_bytes,
                "output_size_in_bytes": self.output_bytes,
                "generated_code_size_in_bytes": 0.0}


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _tensor_leaves(tree):
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in _tensor_leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def input_trees(cfg, shape, mesh):
    """The step's abstract (meta) inputs and their specs, in call order."""
    params = steps.abstract_params(cfg)
    pspecs = sharding.param_specs(params, mesh)
    batch = steps.input_specs(cfg, shape)
    bspecs = sharding.batch_specs(batch, mesh, shape.mode)
    if shape.mode == "train":
        opt_state = steps.abstract_opt_state(cfg)
        ospecs = sharding.opt_state_specs(opt_state, params, mesh)
        return (params, opt_state, batch), (pspecs, ospecs, bspecs)
    if shape.mode == "prefill":
        return (params, batch), (pspecs, bspecs)
    cache = steps.abstract_cache(cfg, shape)
    cspecs = sharding.cache_specs(cache, mesh, shape.global_batch)
    cache_len = torch.empty((), dtype=torch.int32, device="meta")
    return (params, cache, cache_len, batch), \
        (pspecs, cspecs, shardlib.P(), bspecs)


def argument_bytes(cfg, shape, mesh) -> int:
    trees, specs = input_trees(cfg, shape, mesh)
    return sum(local_bytes(t, s, mesh) for t, s in zip(trees, specs,
                                                        strict=True))


def build_lowered(cfg, shape, mesh, dmesh, remat=True):
    """The step with DTensor inputs on ``dmesh`` (inside ``fake_world``
    and ``FakeTensorMode``): the counterpart of the reference's
    ``jit(...).lower``."""
    trees, specs = input_trees(cfg, shape, mesh)
    stats = {"bytes": 0}
    args = tuple(_distribute(t, s, dmesh, stats)
                 for t, s in zip(trees, specs, strict=True))
    if shape.mode == "train":
        fn = steps.make_train_step(cfg, remat=remat)
    elif shape.mode == "prefill":
        fn = steps.make_prefill_step(cfg)
    else:
        fn = _replicated_logits(steps.make_decode_step(cfg))
    return LoweredStep(fn=fn, args=args, argument_bytes=stats["bytes"],
                       rules=sharding.logical_rules(mesh, cfg),
                       mode=shape.mode)


def _replicated_logits(decode):
    """The decode step with the reference's out shardings: the logits
    replicated (``P()``: gathered over the vocab and the batch), the cache
    in its specs (the port's is updated in place)."""
    def run(*args):
        logits, cache = decode(*args)
        return shardlib.constrain(logits, *(None,) * logits.ndim), cache
    return run


def _costs(compiled, chips):
    """(global_flops, global_bytes, global_coll_bytes, coll_detail)."""
    flops = compiled.flops * chips          # recorded per device
    byts = compiled.bytes * chips
    coll = compiled.coll
    cbytes = roofline.collective_bytes(coll) * chips
    return flops, byts, cbytes, coll.get("_counts", {})


def _calib_cfg(cfg, shape, k: int):
    """k-layer calibration config at the config's own chunks."""
    kw = dict(num_layers=k)
    if cfg.num_encoder_layers:
        kw["num_encoder_layers"] = k
    return dataclasses.replace(cfg, **kw)


def _run_depths(cfg, shape, mesh, remat=True, depths=(1, 2)):
    """The k-layer steps (1 and 2 layers) run under the recorder, in one
    fake world, after the first depth's step once as a warm-up:
    {k: CompiledStep}."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    _sharding_rules()
    out = {}
    with fake_world(mesh) as dmesh:
        # an unrecorded warm-up: DTensor's first meeting with each op
        # schema runs work of its own, which no step repeats
        for k in (depths[0],) + tuple(depths):
            with FakeTensorMode(allow_non_fake_inputs=True):
                low = build_lowered(_calib_cfg(cfg, shape, k), shape, mesh,
                                    dmesh, remat=remat)
                out[k] = low.compile()
    return out


def collectives_at_f32(record) -> dict:
    """A record's calibrated collective bytes with every floating payload
    counted at 4 bytes an element, the width the reference's
    host-compiled HLO gives its collectives: {"coll_bytes",
    "per_layer", "outside"}, from its ``coll_sites`` extrapolated as
    ``calibrated_costs`` extrapolates (a record of ``configs``' own
    config).  For holding the port against the reference only: the
    record's own counts are the payloads' true bytes."""
    per = {}
    for k in (1, 2):
        n = 0
        for key, (_, nbytes) in record["coll_sites"][f"L{k}"].items():
            dtype = getattr(torch, key.split(" ")[2].split("[")[0])
            n += nbytes * 4 // dtype.itemsize if dtype.is_floating_point \
                else nbytes
        per[k] = n * record["chips"]
    L = configs.get_config(record["arch"], record["variant"]).num_layers
    dc = per[2] - per[1]
    return {"coll_bytes": per[1] + (L - 1) * dc, "per_layer": dc,
            "outside": per[1] - dc}


def calibrated_costs(cfg, shape, mesh, remat=True, per=None):
    """Cost from the 1-/2-layer runs, extrapolated to L layers."""
    if per is None:
        runs = _run_depths(cfg, shape, mesh, remat=remat)
        per = {k: _costs(runs[k], mesh.devices.size) for k in (1, 2)}
    L = cfg.num_layers
    df = per[2][0] - per[1][0]
    db = per[2][1] - per[1][1]
    dc = per[2][2] - per[1][2]
    counts = {kind: per[1][3].get(kind, 0) + (L - 1) * (
        per[2][3].get(kind, 0) - per[1][3].get(kind, 0))
        for kind in set(per[1][3]) | set(per[2][3])}
    return {
        "flops": per[1][0] + (L - 1) * df,
        "bytes": per[1][1] + (L - 1) * db,
        "coll_bytes": per[1][2] + (L - 1) * dc,
        "per_layer": {"flops": df, "bytes": db, "coll_bytes": dc},
        "outside": {"flops": per[1][0] - df, "bytes": per[1][1] - db,
                    "coll_bytes": per[1][2] - dc},
        "coll_counts_L1": per[1][3],
        "coll_counts_L2": per[2][3],
        "coll_counts": counts,
    }


# The reference's calibrated score traffic per element of a widened score
# matrix (train = fwd + remat + bwd, prefill = fwd), kept for its record.
SCORE_BYTES_PER_ELEM = {"train": 55.0, "prefill": 35.0}


def _attn_score_bytes(cfg, shape) -> float:
    """The reference's analytic traffic of materialised score/prob
    matrices (recorded, not subtracted: see the module docstring)."""
    if not cfg.num_heads or shape.mode == "decode":
        return 0.0
    if cfg.arch_type == "encdec":
        se = shape.seq_len // 2
        sd = shape.seq_len - se
        elems = cfg.num_encoder_layers * se * se + \
            cfg.num_layers * (sd * sd + sd * se)
    else:
        s = shape.seq_len
        elems = cfg.num_layers * s * s
    appearances = 3 if shape.mode == "train" else 1
    factor = SCORE_BYTES_PER_ELEM[shape.mode]
    return float(appearances * factor * shape.global_batch
                 * cfg.num_heads * elems)


def _banded_flops_corr(cfg, shape) -> float:
    """The reference's analytic FLOP reduction from attn_block_skip
    (recorded, not subtracted: see the module docstring)."""
    if not (cfg.attn_block_skip and cfg.num_heads) or shape.mode == "decode":
        return 0.0
    from repro_torch.models.blocks import GLOBAL_WINDOW, layer_windows
    S = shape.seq_len if cfg.arch_type != "encdec" else shape.seq_len // 2
    qc, kc = cfg.attn_q_chunk or 512, cfg.attn_k_chunk or 1024
    wins = np.asarray(layer_windows(cfg))
    fracs = np.where(wins >= GLOBAL_WINDOW, 0.5 + qc / (2 * S),
                     np.minimum(1.0, (wins + qc + kc) / S))
    apps = 3 if shape.mode == "train" else 1
    per_layer_attn = apps * 4.0 * shape.global_batch * cfg.num_heads \
        * S * S * cfg.head_dim
    return float(per_layer_attn * np.sum(1.0 - fracs))


EXTRAPOLATED = ("memory_analysis.temp_size_in_bytes",
                "memory_analysis.output_size_in_bytes", "calibrated")


def lower_and_compile(arch: str, shape_name: str, mesh_name: str,
                      variant: str = "", remat: bool = True,
                      verbose: bool = True, calibrate: bool = True,
                      cfg_override=None):
    cfg = cfg_override or configs.get_config(arch, variant)
    shape = configs.get_shape(shape_name)
    mesh = placeholder_mesh(mesh_name)
    chips = mesh.devices.size

    t0 = time.time()
    runs = _run_depths(cfg, shape, mesh, remat=remat)
    compile_s = time.time() - t0
    per = {k: _costs(runs[k], chips) for k in (1, 2)}
    L = cfg.num_layers
    m1, m2 = runs[1].memory_analysis(), runs[2].memory_analysis()

    def extrap(key):
        return m1[key] + (L - 1) * (m2[key] - m1[key])
    mem_d = {
        "temp_size_in_bytes": extrap("temp_size_in_bytes"),
        "argument_size_in_bytes": float(argument_bytes(cfg, shape, mesh)),
        "output_size_in_bytes": extrap("output_size_in_bytes"),
        "generated_code_size_in_bytes": 0.0,
    }
    full_flops, full_bytes, full_coll, full_counts = per[1]

    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "variant": variant, "chips": chips, "compile_s": round(compile_s, 1),
        "torch": torch.__version__,
        "memory_analysis": mem_d,
        "full_artifact": {
            "flops_body_once": full_flops, "bytes_body_once": full_bytes,
            "coll_bytes_body_once": full_coll, "coll_counts": full_counts,
        },
        "extrapolated": list(EXTRAPOLATED),
        "block_skips": {f"L{k}": runs[k].block_skips for k in (1, 2)},
        "view_replications": {f"L{k}": runs[k].view_replications
                              for k in (1, 2)},
        "retries": {f"L{k}": runs[k].retries for k in (1, 2)},
        "swaps": {f"L{k}": runs[k].swaps for k in (1, 2)},
        "coll_sites": {f"L{k}": runs[k].coll_sites for k in (1, 2)},
        "flop_sites": {f"L{k}": runs[k].flop_sites for k in (1, 2)},
    }
    if per[2][0] < per[1][0] or per[2][1] < per[1][1]:
        raise RuntimeError(
            f"the 2-layer run counted less than the 1-layer run "
            f"(FLOPs {per[1][0]:.4g} -> {per[2][0]:.4g}, bytes "
            f"{per[1][1]:.4g} -> {per[2][1]:.4g}): a count outside the step")

    if calibrate:
        cal = calibrated_costs(cfg, shape, mesh, remat=remat, per=per)
        score_corr = _attn_score_bytes(cfg, shape)
        banded_corr = _banded_flops_corr(cfg, shape)
        rep = roofline.RooflineReport(
            arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
            hlo_flops=cal["flops"], hlo_bytes=cal["bytes"],
            coll_bytes=cal["coll_bytes"], coll_detail=cal["coll_counts_L2"],
            model_flops_=roofline.model_flops(cfg, shape),
            per_device_hbm=mem_d["temp_size_in_bytes"]
            + mem_d["argument_size_in_bytes"])
        result["calibrated"] = cal
        result["attn_score_bytes_corr"] = score_corr
        result["banded_flops_corr"] = banded_corr
        row = rep.row()
        row["memory_naive_ms"] = row["memory_flash_ms"] = row["memory_ms"]
        result["roofline"] = row

    if verbose:
        msg = (f"[dryrun] {arch} x {shape_name} x {mesh_name}"
               f"{' (' + variant + ')' if variant else ''}: "
               f"run {compile_s:.1f}s")
        if calibrate:
            r = result["roofline"]
            msg += (f"  flops {r['flops_T']}T coll {r['coll_G']}GB "
                    f"bottleneck={r['bottleneck']} "
                    f"useful={r['useful_frac']}")
        print(msg)
        print(f"  memory_analysis: {mem_d}")
    return result


def torch_version_of(records) -> str:
    """The one torch version that wrote every record (``"torch"``; a
    record without it counts as its own version): the collectives and
    the counts depend on the version's DTensor rules, so records of two
    versions are not compared or mixed.  Raises ``ValueError`` if they
    differ."""
    versions = {r.get("torch", "unrecorded") for r in records}
    if len(versions) > 1:
        raise ValueError("dry-run records of several torch versions: "
                         f"{sorted(versions)}")
    return versions.pop() if versions else torch.__version__


def save_result(result: dict, tag: str = "") -> str:
    os.makedirs(OUT_DIR, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    fn = (f"{OUT_DIR}/{result['arch']}__{result['shape']}__"
          f"{result['mesh']}{suffix}.json")
    with open(fn, "w") as f:
        json.dump(result, f, indent=1)
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all",
                    help=f"one of {configs.ARCH_NAMES} or 'all'")
    ap.add_argument("--shape", default="all",
                    help="train_4k|prefill_32k|decode_32k|long_500k|all")
    ap.add_argument("--mesh", default="pod",
                    help="pod|multipod|tiny|tiny3d|both")
    ap.add_argument("--variant", default="",
                    help="'' or 'swa' (sliding-window long-context variant)"
                         " or 'opt'")
    ap.add_argument("--tag", default="", help="output filename tag")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-calibrate", action="store_true",
                    help="leave the calibrated costs and the roofline row "
                         "out of the record")
    ap.add_argument("--include-skips", action="store_true")
    args = ap.parse_args(argv)

    archs = configs.ARCH_NAMES if args.arch == "all" else [args.arch]
    shapes = list(configs.SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            if (arch, shape) in configs.SKIPS and not args.include_skips \
                    and not args.variant:
                print(f"[skip] {arch} x {shape}: "
                      f"{configs.SKIPS[(arch, shape)]}")
                continue
            for mesh in meshes:
                try:
                    res = lower_and_compile(
                        arch, shape, mesh, variant=args.variant,
                        remat=not args.no_remat,
                        calibrate=not args.no_calibrate)
                    fn = save_result(res, tag=args.tag or args.variant)
                    print(f"  -> {fn}", flush=True)
                except Exception as e:  # noqa: BLE001 — report every combo
                    traceback.print_exc()
                    failures.append((arch, shape, mesh, str(e)[:200]))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print("\nall dry-runs passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
