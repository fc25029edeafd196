"""Shared building blocks: the MLP and CNN stacks, the linear and dropout helpers.

Counterpart of ``fluid_llm_tpu/models/common.py`` (``mlp_init``/``mlp_apply``,
``cnn_init``/``cnn_apply``, ``cnn1d_init``/``cnn1d_apply``).  Mirrors
``src/models/layers/MLP.py`` and ``CNN.py``: configurable activation,
optional zero-init of the last layer, activation between (not after)
layers; the convolutions have kernel 3 and zero padding 1.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fluid_llm_tpu_torch.ops import quant_matmul as qmm
from fluid_llm_tpu_torch.ops.quant import NF4Linear, QuantLinear

ACTS = {
    "relu": F.relu,
    "leakyrelu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "softplus": F.softplus,
    "linear": lambda x: x,
}


def linear_weight(lin: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    """The ``(out, in)`` weight of a linear in ``dtype``: an ``nn.Linear``'s
    cast, a ``QuantLinear``'s or ``NF4Linear``'s dequantised
    (``backbone.materialize_w``)."""
    if isinstance(lin, (QuantLinear, NF4Linear)):
        return lin.dequantize(dtype)
    return lin.weight.to(dtype)


def linear(x: torch.Tensor, lin: nn.Module, kernels: bool = True,
           cols: Optional[slice] = None) -> torch.Tensor:
    """``x @ w + b`` in the activation dtype (``backbone._linear`` with
    ``materialize_w``); ``cols`` computes those output columns only, for an
    ``nn.Linear`` (the packed qkv, which is never quantized).

    An ``nn.Linear``'s weight is cast at use, as the JAX package's
    ``p["w"].astype(x.dtype)`` (a no-op once cast).  An int8
    ``QuantLinear`` whose shape the kernels take goes to
    ``quant_matmul.int8_matmul`` in its mode (the kernel on CUDA tensors,
    the twin on CPU ones; ``kernels=False`` selects the twin explicitly);
    one they do not take, and an ``NF4Linear``, are dequantised and go
    through ``F.linear``, as ``use_kernel`` and ``materialize_w`` rule.
    Under autograd the int8 product is ``quant_matmul.Int8Matmul``'s."""
    quantized = isinstance(lin, (QuantLinear, NF4Linear))
    if cols is not None:
        if quantized:
            raise ValueError(f"linear: cols= takes an nn.Linear, not {type(lin).__name__}")
        b = lin.bias[cols] if lin.bias is not None else None
        return F.linear(x, lin.weight[cols].to(x.dtype), b.to(x.dtype) if b is not None else None)
    if isinstance(lin, QuantLinear) and qmm.supported(lin.in_features, lin.out_features):
        mm = qmm.int8_matmul if kernels else qmm.int8_matmul_ref
        return mm(x, lin.q, lin.scale, lin.bias, lin.mode)
    w = linear_weight(lin, x.dtype)
    b = lin.bias
    return F.linear(x, w, b.to(x.dtype) if b is not None else None)


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


class CNN(nn.ModuleList):
    """``src/models/layers/CNN.py:4-57``: a list of ``Conv2d`` (``conv_dim``
    2, 3x3) or ``Conv1d`` (``conv_dim`` 1, kernel 3), zero padding 1, on
    channels-first inputs (the JAX ``cnn_apply``/``cnn1d_apply`` in NHWC /
    NWC).  Keys ``<name>.<i>.weight`` like the JAX list of ``{w, b}``."""

    def __init__(self, in_dim: int, out_dim: int, hid_dim: int, num_layers: int, act: str,
                 conv_dim: int = 2, zero_last: bool = False):
        dims = [in_dim] + [hid_dim] * (num_layers - 1) + [out_dim] if num_layers > 1 \
            else [in_dim, out_dim]
        conv = nn.Conv2d if conv_dim == 2 else nn.Conv1d
        super().__init__(conv(a, b, 3, padding=1) for a, b in zip(dims[:-1], dims[1:]))
        if act not in ACTS:
            raise ValueError(f"unknown activation {act!r}")
        self.act = act
        self.zero_last = zero_last and num_layers > 1

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """torch's conv default: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for w and b."""
        for i, conv in enumerate(self):
            if self.zero_last and i == len(self) - 1:
                conv.weight.zero_()
                conv.bias.zero_()
                continue
            bound = 1.0 / math.sqrt(conv.weight[0].numel())
            conv.weight.uniform_(-bound, bound, generator=generator)
            conv.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = ACTS[self.act]
        for i, conv in enumerate(self):
            op = F.conv2d if isinstance(conv, nn.Conv2d) else F.conv1d
            x = op(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), padding=1)
            if i < len(self) - 1:
                x = fn(x)
        return x
