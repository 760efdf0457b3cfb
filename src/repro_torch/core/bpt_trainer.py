"""The local step of the BPT trainer, from ``repro/core/bpt_trainer.py``.

This is the seam the outer layer calls once per node and round:
``make_step_body`` is ``BPTTrainer._make_step_body`` (value and grad,
clip by global norm, the ``warmup_cosine`` learning rate, the optimizer
update, ``apply_updates``) and ``make_node_round`` is
``BPTTrainer._make_node_round`` (``local_steps`` of it, returning the last
loss).  The trainer class, its engines and the merges come with the next
slice of the port.

``loss_fn(params, batch) -> (loss, aux)`` as in the reference.  Params,
optimizer state and batches are nested dicts and lists of tensors; a step
returns new ones and changes none of its inputs.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.core.types import TrainConfig
from repro_torch.optim.optimizers import (apply_updates, clip_by_global_norm,
                                          make_optimizer, warmup_cosine)

__all__ = ["value_and_grad", "make_step_body", "make_node_round"]


def value_and_grad(loss_fn, params, batch):
    """((loss, aux), grads) of ``loss_fn`` at ``params``, grads shaped like
    ``params``; ``params`` themselves are left outside autograd."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, aux = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), aux), tree_unflatten(params, grads)


def make_step_body(loss_fn, train_cfg: TrainConfig):
    """``step_body(params, opt_state, batch, step) -> (params, opt_state,
    loss)``: one optimizer step, the reference's order of operations."""
    opt = make_optimizer(train_cfg.optimizer)
    schedule = warmup_cosine(train_cfg.learning_rate, train_cfg.warmup_steps,
                             train_cfg.total_steps)
    grad_clip = train_cfg.grad_clip

    def step_body(params, opt_state, batch, step):
        (loss, _), grads = value_and_grad(loss_fn, params, batch)
        if grad_clip:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        updates, opt_state = opt.update(grads, opt_state, params,
                                        schedule(step))
        return apply_updates(params, updates), opt_state, loss

    return step_body


def make_node_round(loss_fn, train_cfg: TrainConfig):
    """``node_round(params, opt_state, batches, step) -> (params,
    opt_state, last loss)``: one node's local iteration.  ``batches``
    leaves carry a leading ``local_steps`` axis; ``step`` is the round
    index, held constant over the local steps as the reference's scan
    holds it."""
    step_body = make_step_body(loss_fn, train_cfg)

    def node_round(params, opt_state, batches, step):
        steps = len(tree_leaves(batches)[0])
        loss = None
        for s in range(steps):
            batch = {k: v[s] for k, v in batches.items()}
            params, opt_state, loss = step_body(params, opt_state, batch,
                                                step)
        return params, opt_state, loss

    return node_round
