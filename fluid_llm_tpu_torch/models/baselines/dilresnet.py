"""DilResNet baseline: a dilated residual CNN on grid images.

Counterpart of ``fluid_llm_tpu/models/baselines/dilresnet.py``
(``eagle/Models/DilResNet.py:12-93``): an encoder conv, 4 residual blocks
of 7 dilated 3x3 convs (dilations 1, 2, 4, 8, 4, 2, 1; ReLU after each
conv), a decoder conv; autoregressive diffs with the grid's boundary mask
forced to the ground truth at every step.  The rollout takes and returns
the JAX package's NHWC layout and runs NCHW inside.  The convolutions are
``F.conv2d`` (cuDNN on the card), as the JAX package leaves them to
``lax.conv``, outside any Pallas kernel; weights are ``nn.Conv2d``'s OIHW
(``weights.from_jax_params`` turns the JAX HWIO kernels round), drawn
uniform in ``±1/sqrt(c_in * 9)``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

DILATIONS = (1, 2, 4, 8, 4, 2, 1)


def _conv(c_in: int, c_out: int, dilation: int, generator) -> nn.Conv2d:
    conv = nn.Conv2d(c_in, c_out, 3, padding=dilation, dilation=dilation)  # "SAME"
    bound = 1.0 / math.sqrt(c_in * 9)
    with torch.no_grad():
        for p in conv.parameters():
            p.uniform_(-bound, bound, generator=generator)
    return conv


class DilResNet(nn.Module):
    """``dilresnet_init`` / ``dilresnet_apply``: ``encoder``,
    ``blocks.<b>.<i>``, ``decoder``."""

    def __init__(self, channels: int = 3, n_block: int = 4, hidden: int = 48,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = _conv(channels, hidden, 1, generator)
        self.blocks = nn.ModuleList(
            nn.ModuleList(_conv(hidden, hidden, d, generator) for d in DILATIONS)
            for _ in range(n_block))
        self.decoder = _conv(hidden, channels, 1, generator)

    def step(self, x: torch.Tensor) -> torch.Tensor:
        """One diff prediction: x (B, C, H, W) -> delta (B, C, H, W)."""
        y = self.encoder(x)
        for block in self.blocks:
            h = y
            for conv in block:
                h = F.relu(conv(h))
            y = y + h
        return self.decoder(y)

    def apply(self, state, mask, *, apply_noise: bool = False, noise_std: float = 0.0,
              generator: Optional[torch.Generator] = None):
        """Window rollout (``DilResNet.py:26-61``).

        state (B, T, H, W, C); mask (B, T, H, W) bool, True on the boundary
        (forced each step).  Returns (state_hat (B, T, H, W, C), delta and
        target (B, T-1, H, W, C))."""
        if apply_noise and generator is not None and noise_std > 0:
            noise = torch.randn(state[:, 0].shape, generator=generator, device=state.device,
                                dtype=state.dtype) * noise_std
            state0 = state[:, 0] + noise * (~mask[:, 0])[..., None]
            state = torch.cat([state0[:, None], state[:, 1:]], dim=1)
        x = state.permute(0, 1, 4, 2, 3)  # (B, T, C, H, W)
        m = mask[:, :, None]
        prev = x[:, 0]
        states, deltas, targets = [prev], [], []
        for t in range(1, x.shape[1]):
            delta = self.step(prev)
            targets.append(x[:, t] - prev)
            prev = torch.where(m[:, t], x[:, t], prev + delta)
            states.append(prev)
            deltas.append(delta)
        nhwc = lambda seq: torch.stack(seq, dim=1).permute(0, 1, 3, 4, 2)  # noqa: E731
        return nhwc(states), nhwc(deltas), nhwc(targets)

    forward = apply


def dilresnet_loss(delta, target, w_pressure: float = 1.0) -> torch.Tensor:
    """MSE on the per-step diffs (the ``eagle/train_DilResNet.py`` protocol)."""
    loss_v = ((delta[..., :2] - target[..., :2]) ** 2).mean()
    loss_p = ((delta[..., 2:] - target[..., 2:]) ** 2).mean()
    return loss_v + w_pressure * loss_p
