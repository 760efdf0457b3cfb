"""Configuration: copies of ``ModelConfig``, ``ShapeConfig`` and
``TrainConfig`` (with its choice sets) from ``repro/core/types.py``.

The port keeps its own copies so that it never imports the JAX package.
Field names, defaults, validation and the derived counts are the
reference's, so a config built for one package describes the same model
or run in the other.
"""
from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "ShapeConfig", "TrainConfig", "OUTER_STRATEGIES",
           "PARTITIONINGS", "OPTIMIZERS"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture.  Every config cites its source in
    ``repro_torch/configs/<id>.py``."""

    name: str
    arch_type: str                 # dense|moe|ssm|hybrid|encdec|vlm|audio|cnn
    num_layers: int
    d_model: int
    num_heads: int = 0             # 0 => attention-free
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0           # per-expert FFN width (moe_intermediate)
    moe_capacity_factor: float = 1.25
    # --- SSM (Mamba2/SSD) ---
    ssm_state: int = 0             # N: state size per head
    ssm_heads: int = 0             # H: number of SSD heads
    ssm_head_dim: int = 0          # P: channels per head
    ssm_expand: int = 2
    conv_kernel: int = 4
    # --- attention details ---
    rope_theta: float = 10_000.0
    sliding_window: int = 0        # 0 => full attention
    window_pattern: int = 0        # gemma2: every `pattern`-th layer global
    global_layers: tuple = ()      # hymba: explicit full-attention layer ids
    attn_softcap: float = 0.0      # gemma2 logit soft-capping (attn)
    final_softcap: float = 0.0     # gemma2 final-logit soft-capping
    post_norm: bool = False        # gemma2 post-block norms
    qk_norm: bool = False          # qwen3 per-head q/k RMSNorm
    activation: str = "silu"       # silu | gelu
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # --- enc-dec ---
    num_encoder_layers: int = 0
    # --- multimodal stub frontend ---
    frontend: str = ""             # "" | "audio" | "vision"
    num_frontend_tokens: int = 0   # patches / frames prepended to the text
    # --- kernel/blocking knobs (0 = module default; also used by the
    #     dry-run cost calibration, which sets chunk = seq to remove
    #     inner loops so HLO cost analysis counts every op) ---
    attn_q_chunk: int = 0
    attn_k_chunk: int = 0
    ce_chunk: int = 0
    ssd_chunk: int = 0
    # --- beyond-paper optimization knobs (§Perf; defaults = baseline) ---
    bf16_params_compute: bool = False  # cast layer params to bf16 in-graph
    mlp_megatron: bool = False         # AG(x)+RS(y) MLP instead of FSDP-ish
    embed_reshard: bool = False        # d-shard the embed table pre-lookup
    attn_kv_gather: bool = False       # q/out stay seq-sharded; gather K/V
    embed_onehot: bool = False         # one-hot matmul embedding (TPU-style)
    attn_block_skip: bool = False      # lax.cond-skip masked-out kv blocks
    # --- misc ---
    dtype: str = "bfloat16"        # activation dtype
    param_dtype: str = "float32"
    citation: str = ""

    # ------------------------------------------------------------------
    @property
    def attn_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        """SSM inner width (H * P)."""
        return self.ssm_heads * self.ssm_head_dim

    def param_count(self) -> int:
        """Approximate parameter count N (for 6·N·D model-FLOPs)."""
        d, L = self.d_model, self.num_layers
        total = self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d
        per_layer = 0
        if self.num_heads:
            per_layer += d * self.attn_dim + 2 * d * self.kv_dim \
                + self.attn_dim * d
        if self.num_experts:
            per_layer += self.num_experts * 3 * d * self.expert_d_ff \
                + d * self.num_experts
        elif self.d_ff:
            per_layer += 3 * d * self.d_ff    # gated MLP: wi, wg, wo
        if self.arch_type in ("ssm", "hybrid"):
            di, G, N, H = self.d_inner, 1, self.ssm_state, self.ssm_heads
            proj = 2 * di + 2 * G * N + H
            per_layer += d * proj + di * d + di  # in_proj, out_proj, skip D
        total += L * per_layer
        if self.num_encoder_layers:
            enc_per = d * self.attn_dim * 2 + 2 * d * self.kv_dim \
                + 3 * d * self.d_ff
            total += self.num_encoder_layers * enc_per
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if not self.num_experts:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        dense = self.param_count() - L * self.num_experts * 3 * d * \
            self.expert_d_ff
        return int(dense + L * self.top_k * 3 * d * self.expert_d_ff)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                      # "train" | "prefill" | "decode"


OUTER_STRATEGIES = ("sgwu", "agwu", "sync")
PARTITIONINGS = ("idpa", "udpa")
OPTIMIZERS = ("sgd", "momentum", "adamw")


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    optimizer: str = "adamw"       # sgd | momentum | adamw
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    seed: int = 0
    # --- BPT outer layer ---
    outer_strategy: str = "agwu"   # sgwu | agwu | sync (plain data parallel)
    partitioning: str = "idpa"     # idpa | udpa
    outer_nodes: int = 4           # virtual computing nodes (DP groups)
    allocation_batches: int = 4    # A in Alg. 3.1
    local_steps: int = 1           # h: inner steps between merges (agwu)
    remat: bool = False
    # Fuse the m-node outer layer into ONE vmapped+scanned jitted dispatch
    # per SGWU round (node-stacked params/opt-states) instead of the
    # sequential per-node Python loop.  False keeps the legacy loop — the
    # numerical-equivalence regression tests and the outer_loop benchmark
    # compare the two.  AGWU is unaffected (its event order IS the
    # algorithm).
    fused_outer: bool = True
    # --- device-sharded outer layer ---
    # Place the node axis on a real device mesh (launch/mesh.py `nodes`
    # family): each computing node's params/opt-state/batches live on its
    # own device, the nodes x local_steps grid runs under shard_map, and
    # the SGWU merge is an on-device weighted all-reduce (psum).  Falls
    # back transparently to the fused vmap emulation when fewer than
    # ``outer_nodes`` devices exist.  AGWU places each node's weights on
    # its device and pushes device-resident deltas.
    device_outer: bool = False
    # Named mesh from launch.mesh.MESHES to place the node axis on ("" =
    # auto 1-D `nodes` mesh over the first ``outer_nodes`` devices).  The
    # mesh must expose a `nodes` axis of size ``outer_nodes``.  A 2-D
    # `nodesNxmodelK` hybrid mesh additionally turns on the per-layer
    # inner-parallelism planner (core.planner) over the `model` axis.
    mesh_name: str = ""
    # IDPA heterogeneity in the round data: per-node effective batch sizes
    # proportional to the current allocation, realized as padded+masked
    # stripes so slow nodes/devices carry smaller effective loads while
    # every stripe keeps the static (B, ...) shape the fused/sharded round
    # needs.  The loss_fn must honour an optional batch["mask"].
    uneven_batches: bool = False

    def __post_init__(self):
        """Choice-set validation: a typo'd strategy/partitioning/optimizer
        fails at construction with one canonical message instead of
        mid-train.  Flag-COMBINATION rules (uneven_batches x strategy,
        device/mesh resolution, fallbacks) live in one place —
        ``resolve_engine`` (the reference's ``core/engine.py``; the port's
        comes with its engines) — so a config that needs
        runtime context (device counts) still fails there, before any
        training work, with the same message everywhere."""
        for field, value, allowed in (
                ("outer_strategy", self.outer_strategy, OUTER_STRATEGIES),
                ("partitioning", self.partitioning, PARTITIONINGS),
                ("optimizer", self.optimizer, OPTIMIZERS)):
            if value not in allowed:
                raise ValueError(
                    f"TrainConfig.{field}={value!r}: choose one of "
                    f"{allowed}")
        if self.outer_nodes < 1:
            raise ValueError(
                f"TrainConfig.outer_nodes={self.outer_nodes}: need >= 1")
        if self.local_steps < 1:
            raise ValueError(
                f"TrainConfig.local_steps={self.local_steps}: need >= 1")
