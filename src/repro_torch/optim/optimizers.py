"""Optimizers (SGD / momentum / AdamW) and LR schedules, from
``repro/optim/optimizers.py``: pure functions over params as nested dicts
and lists of tensors.

``init(params) -> state``; ``update(grads, state, params, lr) ->
(updates, state)``; apply with ``apply_updates``.  Nothing is updated in
place, so a node's params and state can be kept, stacked or merged as the
reference's outer layer does.  Moments are f32 whatever the param dtype.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map

__all__ = ["Optimizer", "sgd", "momentum", "adamw", "apply_updates",
           "global_norm", "clip_by_global_norm", "warmup_cosine",
           "make_optimizer"]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable        # (grads, state, params, lr) -> (updates, state)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in f32, on the leaves'
    device (no host sync)."""
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def _zeros_f32(p):
    return torch.zeros_like(p, dtype=torch.float32)


# ----------------------------------------------------------------------
def sgd() -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr):
        return tree_map(lambda g: -lr * g, grads), state
    return Optimizer(init, update)


def momentum(beta: float = 0.9) -> Optimizer:
    def init(params):
        return tree_map(_zeros_f32, params)

    def update(grads, state, params, lr):
        new_v = tree_map(lambda v, g: beta * v + g.float(), state, grads)
        return tree_map(lambda v: -lr * v, new_v), new_v
    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    def init(params):
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else "cpu"
        return {"mu": tree_map(_zeros_f32, params),
                "nu": tree_map(_zeros_f32, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params, lr):
        count = state["count"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state["mu"], grads)
        nu = tree_map(lambda n, g: b2 * n + (1 - b2) * g.float().square(),
                      state["nu"], grads)
        c1 = 1 - torch.pow(b1, count.float())
        c2 = 1 - torch.pow(b2, count.float())
        upd = tree_map(
            lambda m, n, p: -lr * ((m / c1) / (torch.sqrt(n / c2) + eps)
                                   + weight_decay * p.float()),
            mu, nu, params)
        return upd, {"mu": mu, "nu": nu, "count": count}
    return Optimizer(init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "sgd":
        return sgd()
    if name == "momentum":
        return momentum(**kw)
    if name == "adamw":
        return adamw(**kw)
    raise ValueError(name)


# ----------------------------------------------------------------------
def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    """Linear warm-up to ``base_lr`` over ``warmup_steps``, then a cosine
    decay to ``min_ratio * base_lr`` at ``total_steps``.  ``schedule(step)``
    is a Python float holding the f32 value the reference computes."""
    f32 = torch.float32

    def schedule(step) -> float:
        step = torch.tensor(float(step), dtype=f32)
        warm = base_lr * step / max(warmup_steps, 1)
        frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        frac = torch.clamp(frac, 0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * frac)))
        return float(torch.where(step < warmup_steps, warm, cos))
    return schedule
