"""Step functions (train / prefill / decode) and abstract input specs, from
``repro/launch/steps.py``.

``input_specs``, ``abstract_params``, ``abstract_opt_state`` and
``abstract_cache`` return tensors on the ``meta`` device: the shapes and
dtypes of every model input, param, optimizer state and cache with no
storage (the reference's ``ShapeDtypeStruct`` stand-ins and
``eval_shape``).  The makers return plain functions over the port's
param trees; the train step takes its gradients with
``core.bpt_trainer.value_and_grad``.
"""
from __future__ import annotations

import torch

from repro_torch.core.bpt_trainer import value_and_grad
from repro_torch.core.types import ModelConfig, ShapeConfig
from repro_torch.models import encdec, lm
from repro_torch.optim.optimizers import (apply_updates, clip_by_global_norm,
                                          make_optimizer)

__all__ = ["input_specs", "abstract_params", "abstract_opt_state",
           "abstract_cache", "make_train_step", "make_prefill_step",
           "make_decode_step", "enc_len", "text_len"]

F32 = torch.float32
BF16 = torch.bfloat16
I32 = torch.int32


def enc_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Encoder length for enc-dec archs: half the shape budget."""
    return shape.seq_len // 2


def text_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Decoder/text token count so total processed length == seq_len."""
    if cfg.arch_type == "encdec":
        return shape.seq_len - enc_len(cfg, shape)
    if cfg.frontend:
        return shape.seq_len - cfg.num_frontend_tokens
    return shape.seq_len


def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


# ----------------------------------------------------------------------
# Abstract inputs
# ----------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Abstract host batch for the given shape preset."""
    B = shape.global_batch
    if shape.mode in ("train", "prefill"):
        T = text_len(cfg, shape)
        batch = {"tokens": _spec((B, T), I32)}
        if shape.mode == "train":
            batch["labels"] = _spec((B, T), I32)
        if cfg.arch_type == "encdec":
            batch["frontend_embeds"] = _spec(
                (B, enc_len(cfg, shape), cfg.d_model), BF16)
        elif cfg.frontend:
            batch["frontend_embeds"] = _spec(
                (B, cfg.num_frontend_tokens, cfg.d_model), BF16)
        return batch
    # decode: one token against a seq_len cache
    return {"tokens": _spec((B, 1), I32)}


def abstract_params(cfg: ModelConfig):
    if cfg.arch_type == "encdec":
        return encdec.init_encdec_params(cfg, None, device="meta")
    return lm.init_params(cfg, None, device="meta")


def abstract_opt_state(cfg: ModelConfig, optimizer: str = "adamw"):
    return make_optimizer(optimizer).init(abstract_params(cfg))


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig):
    B = shape.global_batch
    if cfg.arch_type == "encdec":
        return encdec.init_encdec_cache(cfg, B, shape.seq_len,
                                        enc_len(cfg, shape), device="meta")
    return lm.init_cache(B, shape.seq_len, cfg, device="meta")


# ----------------------------------------------------------------------
# Steps
# ----------------------------------------------------------------------
def make_train_step(cfg: ModelConfig, optimizer: str = "adamw",
                    learning_rate: float = 3e-4, grad_clip: float = 1.0,
                    remat: bool = True):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {'loss', 'grad_norm'})``: the loss and its gradients, clipped by their
    global norm, then one optimizer update at ``learning_rate``."""
    opt = make_optimizer(optimizer)
    if cfg.arch_type == "encdec":
        def loss(params, batch):
            return encdec.encdec_loss_fn(params, batch, cfg)
    else:
        def loss(params, batch):
            return lm.loss_fn(params, batch, cfg, remat=remat)

    def train_step(params, opt_state, batch):
        (lval, _), grads = value_and_grad(loss, params, batch)
        if grad_clip:
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
        else:
            gnorm = torch.zeros((), dtype=F32, device=lval.device)
        updates, opt_state = opt.update(grads, opt_state, params,
                                        learning_rate)
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": lval, "grad_norm": gnorm}
    return train_step


def make_prefill_step(cfg: ModelConfig):
    """``prefill(params, batch)``: the last position's hidden state (B, d)
    of the prompt, and for a decoder-only arch the per-layer caches
    stacked on a leading L axis (``lm.forward``'s), front-end positions
    first.  The encoder-decoder's prefill fills no cache, as the
    reference's does not."""
    if cfg.arch_type == "encdec":
        def prefill(params, batch):
            memory = encdec.encode(params, batch["frontend_embeds"], cfg)
            hidden = encdec._decode_stack(
                params, encdec.embed_tokens(params, batch["tokens"], cfg),
                memory, cfg)
            return hidden[:, -1]
        return prefill

    def prefill(params, batch):
        hidden, caches, _ = lm.forward(
            params, batch["tokens"], cfg,
            frontend_embeds=batch.get("frontend_embeds"), collect_cache=True)
        return hidden[:, -1], caches
    return prefill


def make_decode_step(cfg: ModelConfig):
    """``decode(params, cache, cache_len, batch) -> (logits (B, 1, V) f32,
    cache)``, the cache updated in place."""
    if cfg.arch_type == "encdec":
        def decode(params, cache, cache_len, batch):
            return encdec.encdec_decode_step(params, cache, cache_len,
                                             batch["tokens"], cfg)
        return decode

    def decode(params, cache, cache_len, batch):
        return lm.decode_step(params, cache, cache_len, batch["tokens"], cfg)
    return decode
