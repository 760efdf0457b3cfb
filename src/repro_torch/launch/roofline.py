"""Roofline terms from a dry-run, from ``repro/launch/roofline.py``.

    compute term    = FLOPs            / (chips * peak_FLOP/s)
    memory term     = bytes            / (chips * HBM_bw)
    collective term = collective_bytes / (chips * link_bw)

Two sets of rates, both from the NVIDIA H100 SXM 80GB data sheet:

- ``HW`` keeps the reference's field names with the rates the planner
  (``core/planner.py``) scores the CNN's layer plans with: ``peak_flops``
  67e12 FLOP/s, the f32 FMA rate (the CNN trains in f32); ``hbm_bw``
  3.35e12 B/s of HBM3; ``ici_bw`` 450e9 B/s, NVLink 4's rate in one
  direction (the link the model-axis collectives of a multi-card node
  cross).
- ``LM_HW`` is what ``RooflineReport`` scores the LM dry-runs with by
  default: the same memory and link rates and the dense bf16 tensor-core
  rate, 989e12 FLOP/s (H100 SXM data sheet, dense, without sparsity), as
  the reference's report uses its own chip's bf16 rate.

The rows are estimates from these data-sheet rates, never measurements.
The collective term charges ``ici_bw`` on every link: a cluster of
256 H100 has NVLink only inside each 8-card node, so the term is a lower
bound across nodes.

The reference parses the collectives out of compiled HLO text; the port
has no compiled program, so ``CollectiveRecorder`` stands in for
``parse_hlo_collectives``: the dry-run's dispatch mode hands it the
functional collectives a DTensor step issues on its local shards, and it
returns the same dict (kind -> summed output bytes on one device, plus
``_counts``).
``analyze_compiled`` takes the dry-run's recorded step in place of a
compiled artifact.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional

__all__ = ["HW", "LM_HW", "RooflineReport", "analyze_compiled",
           "call_site", "collective_bytes", "CollectiveRecorder",
           "COLLECTIVE_KINDS", "model_flops"]


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 67e12         # f32 FMA FLOP/s (H100 SXM data sheet)
    hbm_bw: float = 3.35e12           # HBM3 bytes/s (H100 SXM data sheet)
    ici_bw: float = 450e9             # NVLink 4 bytes/s, one direction


# dense bf16 tensor-core FLOP/s of the H100 SXM (data sheet, no sparsity)
LM_HW = HW(peak_flops=989e12)

# functional collective (``torch.ops._c10d_functional``) -> HLO kind.
# ``permute_tensor`` (``_functional_collectives``) dispatches as an
# ``all_to_all_single`` that sends to one peer and receives from one:
# ``_kind`` names that one a collective-permute, as the HLO does
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
}


def _one_peer(args) -> bool:
    """Whether an ``all_to_all_single``'s (input, output splits, input
    splits, group) move data to one peer and from one (a permute)."""
    if len(args) < 3 or not all(isinstance(s, (list, tuple))
                                for s in args[1:3]):
        return False
    return all(sum(1 for n in s if n) == 1 for s in args[1:3])


def _kind(func, args=()) -> Optional[str]:
    """The HLO kind of a collective op (its ``args`` tell a permute from
    an all-to-all), None for any other op.  The in-place ``c10d`` ops
    (broadcast, scatter, ...) are process-group set-up, never a step's;
    they raise, so none is counted silently."""
    ns = getattr(func, "namespace", "")
    name = func._overloadpacket.__name__
    if ns in ("_c10d_functional", "_dtensor"):
        if name == "all_to_all_single" and _one_peer(args):
            return COLLECTIVE_KINDS["permute_tensor"]
        if name in COLLECTIVE_KINDS:
            return COLLECTIVE_KINDS[name]
        if "permute" in name:
            return "collective-permute"
        if ns == "_dtensor" or name == "wait_tensor":
            return None
        raise RuntimeError(f"unmapped collective {ns}.{name}")
    if ns == "c10d":
        raise RuntimeError(f"c10d.{name} inside a recorded step: a set-up "
                           "collective, not the step's")
    return None


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class CollectiveRecorder:
    """Sums what ``parse_hlo_collectives`` sums, from a step's dispatch.

    ``add(func, out, args)`` is called by the dry-run's dispatch mode for
    every local op; ``result()`` is the reference's dict: kind -> summed
    output bytes on one device, and ``_counts``: kind -> number of
    collectives.
    ``sites`` keeps each collective's call site: "kind op dtype[shape] @
    file:line < caller" -> [count, bytes], the frames the port's
    innermost three outside the dry-run's and the sharding layer's own
    (``call_site``).
    """

    def __init__(self):
        self.bytes: dict[str, int] = {}
        self.counts: dict[str, int] = {}
        self.sites: dict[str, list] = {}

    def add(self, func, out, args=()) -> bool:
        kind = _kind(func, args)
        if kind is None:
            return False
        outs = out if isinstance(out, (list, tuple)) else [out]
        b = sum(_nbytes(t) for t in outs if hasattr(t, "numel"))
        self.bytes[kind] = self.bytes.get(kind, 0) + b
        self.counts[kind] = self.counts.get(kind, 0) + 1
        t = outs[0]
        key = (f"{kind} {func._overloadpacket.__name__} "
               f"{str(t.dtype).removeprefix('torch.')}"
               f"[{','.join(map(str, t.shape))}] "
               f"@ {call_site()}")
        site = self.sites.setdefault(key, [0, 0])
        site[0] += 1
        site[1] += b
        return True

    def result(self) -> dict:
        out = dict(self.bytes)
        out["_counts"] = dict(self.counts)
        return out


# the recorder's and the sharding layer's own frames, never a call site
_NOT_SITES = ("launch/roofline.py", "launch/dryrun.py", "core/shardlib.py")


def call_site(depth: int = 3) -> str:
    """The innermost ``depth`` frames of the port's package that issued
    an op (a collective, a counted FLOP), as package-relative ``file:line``, innermost first,
    outside ``_NOT_SITES``; where there are none (the dry-run's own out
    shardings), the dry-run's innermost public function."""
    found, fallback = [], None
    f = sys._getframe(1)
    while f is not None and len(found) < depth:
        name = f.f_code.co_filename.replace(os.sep, "/")
        i = name.rfind("repro_torch/")
        if i >= 0:
            rel = f"{name[i + len('repro_torch/'):]}:{f.f_lineno}"
            if not rel.startswith(_NOT_SITES):
                found.append(rel)
            elif fallback is None and rel.startswith(_NOT_SITES[1]) and \
                    not f.f_code.co_name.startswith("_"):
                fallback = rel
        f = f.f_back
    return " < ".join(found) or fallback or "?"


def collective_bytes(coll: dict) -> int:
    """Summed bytes of a recorder's dict (``_counts`` left out)."""
    return sum(v for k, v in coll.items() if not k.startswith("_"))


def model_flops(cfg, shape, text_tokens: Optional[int] = None) -> float:
    """6·N·D (dense) or 6·N_active·D (MoE); D = tokens processed.

    enc-dec: encoder params see encoder tokens, decoder params decoder
    tokens (cross-attention keys priced with the decoder side).
    """
    mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[shape.mode]
    if cfg.arch_type == "encdec":
        d, L = cfg.d_model, cfg.num_layers
        per_enc = 2 * d * cfg.attn_dim + 2 * d * cfg.kv_dim + 3 * d * cfg.d_ff
        per_dec = 2 * (2 * d * cfg.attn_dim + 2 * d * cfg.kv_dim) \
            + 3 * d * cfg.d_ff
        n_enc = cfg.num_encoder_layers * per_enc
        n_dec = L * per_dec + cfg.vocab_size * d
        se = shape.seq_len // 2
        sd = shape.seq_len - se
        if shape.mode == "decode":
            return mult * n_dec * shape.global_batch
        return mult * shape.global_batch * (n_enc * se + n_dec * sd)
    if shape.mode == "decode":
        tokens = shape.global_batch     # one token per sequence
    else:
        tokens = shape.global_batch * shape.seq_len
    n = cfg.active_param_count()
    return mult * n * tokens


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_detail: dict
    model_flops_: float
    per_device_hbm: float              # peak memory per device (bytes)

    def terms(self, hw: HW | None = None) -> dict:
        hw = hw or LM_HW
        t_c = self.hlo_flops / (self.chips * hw.peak_flops)
        t_m = self.hlo_bytes / (self.chips * hw.hbm_bw)
        t_x = self.coll_bytes / (self.chips * hw.ici_bw)
        dom = max((("compute", t_c), ("memory", t_m), ("collective", t_x)),
                  key=lambda kv: kv[1])
        return {
            "compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
            "bottleneck": dom[0], "bound_s": dom[1],
            "useful_flop_frac": (self.model_flops_ / self.hlo_flops
                                 if self.hlo_flops else 0.0),
        }

    def row(self, hw: HW | None = None) -> dict:
        t = self.terms(hw)
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_T": round(self.hlo_flops / 1e12, 2),
            "bytes_G": round(self.hlo_bytes / 1e9, 2),
            "coll_G": round(self.coll_bytes / 1e9, 3),
            "compute_ms": round(t["compute_s"] * 1e3, 3),
            "memory_ms": round(t["memory_s"] * 1e3, 3),
            "collective_ms": round(t["collective_s"] * 1e3, 3),
            "bottleneck": t["bottleneck"],
            "useful_frac": round(t["useful_flop_frac"], 3),
            "hbm_per_dev_GB": round(self.per_device_hbm / 2**30, 3),
        }


def analyze_compiled(compiled, arch: str, shape_name: str, mesh_name: str,
                     chips: int, cfg=None, shape=None) -> RooflineReport:
    """A report from one recorded step (``dryrun.LoweredStep.compile()``'s
    ``CompiledStep``), as the reference's from a compiled artifact: the
    per-device FLOPs and bytes as recorded, the collectives' bytes on one
    device, and temp + argument + output bytes as the per-device
    memory."""
    coll = compiled.coll
    mem = compiled.memory_analysis()
    per_dev = float(sum(mem[a] for a in (
        "temp_size_in_bytes", "argument_size_in_bytes",
        "output_size_in_bytes")))
    mf = model_flops(cfg, shape) if cfg is not None and shape is not None \
        else 0.0
    return RooflineReport(arch, shape_name, mesh_name, chips,
                          float(compiled.flops), float(compiled.bytes),
                          float(collective_bytes(coll)), coll, mf, per_dev)
