"""Shared building blocks: the MLP stack, the linear and dropout helpers.

Counterpart of ``fluid_llm_tpu/models/common.py`` (``mlp_init``/``mlp_apply``;
the CNN stacks come with the CNN encoder/decoder).  Mirrors
``src/models/layers/MLP.py``: configurable activation, optional zero-init of
the last layer, activation between (not after) layers.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

ACTS = {
    "relu": F.relu,
    "leakyrelu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "softplus": F.softplus,
    "linear": lambda x: x,
}


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """``x @ w + b`` in the activation dtype (weights cast at use, as the
    JAX package's ``p["w"].astype(x.dtype)``; a no-op once cast)."""
    b = lin.bias.to(x.dtype) if lin.bias is not None else None
    return F.linear(x, lin.weight.to(x.dtype), b)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout with the mask drawn from ``generator`` (on x's
    device): keep with probability ``1 - rate``, scale kept values by
    ``1 / (1 - rate)`` (the JAX package's ``bernoulli`` + ``where``)."""
    if rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class MLP(nn.ModuleList):
    """``src/models/layers/MLP.py:4-47``: a list of linears, so the state-dict
    keys are ``<name>.<i>.weight`` like the JAX list of ``{w, b}``."""

    def __init__(self, in_dim: int, out_dim: int, hid_dim: int, num_layers: int,
                 act: str, zero_last: bool = False):
        dims = [in_dim] + [hid_dim] * (num_layers - 1) + [out_dim] if num_layers > 1 \
            else [in_dim, out_dim]
        super().__init__(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        if act not in ACTS:
            raise ValueError(f"unknown activation {act!r}")
        self.act = act
        self.zero_last = zero_last

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """torch nn.Linear's default: U(-1/sqrt(in), 1/sqrt(in)) for w and b."""
        for i, lin in enumerate(self):
            if self.zero_last and i == len(self) - 1 and len(self) > 1:
                lin.weight.zero_()
                lin.bias.zero_()
                continue
            bound = 1.0 / math.sqrt(lin.in_features)
            lin.weight.uniform_(-bound, bound, generator=generator)
            lin.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = ACTS[self.act]
        for i, lin in enumerate(self):
            x = linear(x, lin)
            if i < len(self) - 1:
                x = fn(x)
        return x
