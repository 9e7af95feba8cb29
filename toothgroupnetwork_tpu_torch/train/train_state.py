"""Optimizer factory (counterpart of toothgroupnetwork_tpu/train/train_state.py).

The JAX package's optax chains, as torch optimizers with the same updates:
  * sgd: ``add_decayed_weights -> trace(momentum) -> lr`` is
    ``torch.optim.SGD(momentum, weight_decay, dampening=0, nesterov=False)``
    (the first step's trace is the gradient itself in both);
  * adam: the decay folded into the gradient as L2 (torch ``weight_decay``,
    not decoupled AdamW), betas (0.9, 0.999), eps 1e-8.
The learning rate lives in the parameter groups; the trainer sets it per
epoch or every ``step_batches`` batches (:func:`set_learning_rate`).
"""

from __future__ import annotations

import torch

from .config import OptimizerConfig


def make_optimizer(cfg: OptimizerConfig, params) -> torch.optim.Optimizer:
    if cfg.name == "adam":
        return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=cfg.weight_decay)
    if cfg.name == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                               dampening=0.0, weight_decay=cfg.weight_decay,
                               nesterov=False)
    raise ValueError(f"unknown optimizer {cfg.name!r}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
