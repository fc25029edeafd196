"""Optimizers and the StepLR schedule.

Counterpart of ``fluid_llm_tpu/train/optim.py`` (``src/trainer.py:222-247``).
The optimizer holds only trainable parameters (``requires_grad``), so the
frozen backbone under LoRA has no moments, as the JAX package's partition.

- ``adamw``: ``torch.optim.AdamW``, the same decoupled decay as optax
  ``adamw`` (betas (0.9, 0.999), eps 1e-8 outside the square root);
- ``adam`` and ``sgd``: torch's own L2 forms (decay added to the gradient),
  which the JAX package reproduces with ``add_decayed_weights``;
- ``adafactor`` (a TPU-side addition of the JAX package) and gradient
  accumulation (``grad_accum_steps > 1``) are not ported and raise.

The learning rate is set per epoch from ``steplr``, indexed by the global
epoch (``loop.py:107-110``).
"""

from __future__ import annotations

from typing import Iterable

import torch

from fluid_llm_tpu_torch.config import Config


def steplr(base_lr: float, step_size: int, gamma: float):
    """torch ``StepLR``: lr * gamma**(epoch // step_size)."""

    def schedule(epoch: int) -> float:
        return base_lr * (gamma ** (epoch // step_size))

    return schedule


def build_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    params = list(params)
    lr, wd = cfg.learning_rate, cfg.weight_decay
    if cfg.grad_accum_steps > 1:
        raise NotImplementedError("grad_accum_steps > 1 is not ported")
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=lr, weight_decay=wd)
    if cfg.optimizer == "adafactor":
        raise NotImplementedError("adafactor is not ported (a JAX-side addition)")
    raise ValueError(f"Unknown optimizer type: {cfg.optimizer}")


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr
