"""Optimizers and the StepLR schedule.

Counterpart of ``fluid_llm_tpu/train/optim.py`` (``src/trainer.py:222-247``).
The optimizer holds only trainable parameters (``requires_grad``), so the
frozen backbone under LoRA has no moments, as the JAX package's partition.

- ``adamw``: ``torch.optim.AdamW``, the same decoupled decay as optax
  ``adamw`` (betas (0.9, 0.999), eps 1e-8 outside the square root);
- ``adam`` and ``sgd``: torch's own L2 forms (decay added to the gradient),
  which the JAX package reproduces with ``add_decayed_weights``;
- ``adafactor``: :class:`Adafactor`, optax ``adafactor`` with its defaults
  (the JAX package's addition; ``torch.optim.Adafactor`` follows other
  rules);
- ``grad_accum_steps > 1``: :class:`MultiSteps`, optax ``MultiSteps``
  (the reference's ``accelerator.accumulate``, ``src/main.py:68``).

The learning rate is set per epoch from ``steplr``, indexed by the global
epoch (``loop.py:107-110``).
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from fluid_llm_tpu_torch.config import Config


def steplr(base_lr: float, step_size: int, gamma: float):
    """torch ``StepLR``: lr * gamma**(epoch // step_size)."""

    def schedule(epoch: int) -> float:
        return base_lr * (gamma ** (epoch // step_size))

    return schedule


# optax ``adafactor``'s defaults
DECAY_RATE = 0.8  # second-moment decay 1 - (t+1)^-0.8
EPS = 1e-30  # added to g^2
MIN_DIM_SIZE_TO_FACTOR = 128
CLIPPING_THRESHOLD = 1.0  # block RMS of the update
MIN_SCALE = 1e-3  # floor of the parameter's block RMS


def factored_dims(shape: torch.Size) -> Optional[tuple[int, int]]:
    """The two largest axes (second largest, largest) when the second is at
    least ``MIN_DIM_SIZE_TO_FACTOR`` long, else None (optax
    ``_factored_dims``: numpy's argsort order, so ties go to the earlier
    axis first)."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: (shape[i], i))
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return order[-2], order[-1]


class Adafactor(torch.optim.Optimizer):
    """optax ``adafactor`` (``optax/_src/alias.py``) with its defaults, per
    parameter tensor:

    - second moment with decay ``1 - (t+1)^-0.8``, of ``g^2 + 1e-30``,
      factored into row and column means over the two largest axes when
      both are at least 128 long (``scale_by_factored_rms``);
    - the update clipped to block RMS 1 (``clip_by_block_rms``), times the
      learning rate and ``max(rms(p), 1e-3)`` (``scale_by_param_block_rms``);
    - no momentum; ``weight_decay_rate`` (None: none) adds ``rate * p``
      after the learning rate, as optax chains it.
    """

    def __init__(self, params, lr: float, weight_decay_rate: Optional[float] = None):
        super().__init__(params, dict(lr=lr, weight_decay_rate=weight_decay_rate))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g, state = p.grad, self.state[p]
                dims = factored_dims(p.shape)
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.int64)
                    if dims is None:
                        state["v"] = torch.zeros_like(p)
                    else:
                        state["v_row"] = torch.zeros_like(p.sum(dim=dims[1]))
                        state["v_col"] = torch.zeros_like(p.sum(dim=dims[0]))
                t = float(state["step"]) + 1.0
                decay = 1.0 - torch.tensor(t, dtype=torch.float32) ** -DECAY_RATE
                decay = decay.to(p.device)
                g2 = g * g + EPS
                if dims is None:
                    v = decay * state["v"] + (1.0 - decay) * g2
                    state["v"] = v
                    u = g * v ** -0.5
                else:
                    d1, d0 = dims
                    v_row = decay * state["v_row"] + (1.0 - decay) * g2.mean(dim=d0)
                    v_col = decay * state["v_col"] + (1.0 - decay) * g2.mean(dim=d1)
                    state["v_row"], state["v_col"] = v_row, v_col
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
                    u = g * row_factor.unsqueeze(d0) * v_col.unsqueeze(d1) ** -0.5
                state["step"] += 1
                u = u / torch.clamp(u.square().mean().sqrt() / CLIPPING_THRESHOLD, min=1.0)
                u = u * group["lr"]
                u = u * torch.clamp(p.square().mean().sqrt(), min=MIN_SCALE)
                if group["weight_decay_rate"] is not None:
                    u = u + group["weight_decay_rate"] * p
                p.sub_(u)


class MultiSteps:
    """optax ``MultiSteps`` around ``inner``: each ``step`` folds the
    gradients into their running mean over the micro-batches; every
    ``k``-th the inner optimizer steps on that mean and the mean restarts.
    In between, the parameters are unchanged.  A parameter without a
    gradient counts as a zero one.  ``param_groups`` are the inner's, so
    :func:`set_learning_rate` reaches it."""

    def __init__(self, inner: torch.optim.Optimizer, k: int):
        if k < 2:
            raise ValueError(f"MultiSteps needs k >= 2, got {k}")
        self.inner, self.k = inner, k
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in self._params()]

    @property
    def param_groups(self):
        return self.inner.param_groups

    def _params(self) -> list[torch.nn.Parameter]:
        return [p for group in self.inner.param_groups for p in group["params"]]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        params = self._params()
        for p, acc in zip(params, self.acc):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            acc.add_((g - acc) / (self.mini_step + 1))
        if self.mini_step == self.k - 1:
            for p, acc in zip(params, self.acc):
                p.grad = acc.clone()
            self.inner.step()
            for acc in self.acc:
                acc.zero_()
        self.mini_step = (self.mini_step + 1) % self.k

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step,
                "acc": [a.clone() for a in self.acc]}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.mini_step = int(state["mini_step"])
        for acc, saved in zip(self.acc, state["acc"]):
            acc.copy_(saved)


def build_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]):
    params = list(params)
    lr, wd = cfg.learning_rate, cfg.weight_decay
    if cfg.optimizer == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    elif cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    elif cfg.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=lr, weight_decay=wd)
    elif cfg.optimizer == "adafactor":
        opt = Adafactor(params, lr=lr, weight_decay_rate=wd if wd else None)
    else:
        raise ValueError(f"Unknown optimizer type: {cfg.optimizer}")
    return MultiSteps(opt, cfg.grad_accum_steps) if cfg.grad_accum_steps > 1 else opt


def set_learning_rate(opt, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr
