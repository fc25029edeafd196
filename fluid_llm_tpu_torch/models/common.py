"""Shared building blocks: the MLP and CNN stacks, the linear and dropout helpers.

Counterpart of ``fluid_llm_tpu/models/common.py`` (``mlp_init``/``mlp_apply``,
``cnn_init``/``cnn_apply``, ``cnn1d_init``/``cnn1d_apply``).  Mirrors
``src/models/layers/MLP.py`` and ``CNN.py``: configurable activation,
optional zero-init of the last layer, activation between (not after)
layers; the convolutions have kernel 3 and zero padding 1.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fluid_llm_tpu_torch.ops import quant_matmul as qmm
from fluid_llm_tpu_torch.ops.quant import NF4Linear, QuantLinear, dequantize_weight
from fluid_llm_tpu_torch.parallel import tensor as pt

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
    (``backbone.materialize_w``).  On a mesh: its fsdp chunks gathered and,
    in a tensor-parallel block, this rank's features
    (``parallel/tensor.py``)."""
    if isinstance(lin, QuantLinear):
        w = dequantize_weight(pt.full(lin, "q"), pt.full(lin, "scale"), dtype)
    elif isinstance(lin, NF4Linear):
        w = lin.dequantize(dtype)
    else:
        w = pt.full(lin, "weight").to(dtype)
    tp = pt.tp_of(lin)
    return w if tp is None else tp.cut(w)


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
    Under autograd the int8 product is ``quant_matmul.Int8Matmul``'s.
    A linear of a tensor-parallel block runs on this rank's features between
    its Megatron pair (``parallel/tensor.py``; a row-parallel bias added
    once, after the reduction)."""
    quantized = isinstance(lin, (QuantLinear, NF4Linear))
    x = pt.enter(lin, x)
    late = pt.row_bias(lin)
    b = lin.bias
    if cols is not None:
        if quantized:
            raise ValueError(f"linear: cols= takes an nn.Linear, not {type(lin).__name__}")
        b = b[cols] if b is not None else None
        w = pt.full(lin, "weight")
        return F.linear(x, w[cols].to(x.dtype), b.to(x.dtype) if b is not None else None)
    if isinstance(lin, QuantLinear) and qmm.supported(lin.in_features, lin.out_features):
        mm = qmm.int8_matmul if kernels else qmm.int8_matmul_ref
        y = mm(x, pt.full(lin, "q"), pt.full(lin, "scale"), None if late else b, lin.mode)
    else:
        w = linear_weight(lin, x.dtype)
        y = F.linear(x, w, b.to(x.dtype) if b is not None and not late else None)
    if late:
        y = pt.leave(lin, y)
        if b is not None:
            y = y + b.to(y.dtype)
    return y


# The one-process layout of the random draws (``draw_shards``): this rank's
# rows of the global batch, and its tokens of the sequence.
_ROWS: list = []
_TOKENS: list = []


@contextmanager
def draw_shards(rows: Optional[tuple[int, int, int]] = None,
                tokens: Optional[tuple[int, int, int, int]] = None):
    """Within the block, :func:`draw` draws what one process would and keeps
    this rank's part.  ``rows``: ``(start, stop, total)`` of the global
    batch rows held here (dim 0 of a drawn tensor, or a flattening that
    leads with the batch); ``tokens``: ``(start, stop, length, padded)``,
    this rank's chunk of a sequence of ``length`` tokens padded to
    ``padded`` (dim 1 of a drawn tensor that is that chunk, or the whole
    padded sequence; padded tokens draw nothing)."""
    if rows is not None:
        _ROWS.append(rows)
    if tokens is not None:
        _TOKENS.append(tokens)
    try:
        yield
    finally:
        if rows is not None:
            _ROWS.pop()
        if tokens is not None:
            _TOKENS.pop()


def draw(fn, shape, generator: torch.Generator, device,
         features: Optional[tuple[int, int, int]] = None) -> torch.Tensor:
    """``fn(shape, generator=, device=)`` (``torch.rand``/``torch.randn``);
    under :func:`draw_shards` the one-process draw of the global shape,
    cut to this rank's part.  ``features``: ``(start, stop, total)`` of the
    last dim held here (the input of a row-parallel adapter)."""
    shape = tuple(shape)
    if not (_ROWS or _TOKENS or features):
        return fn(shape, generator=generator, device=device)
    full, index, pad = list(shape), [slice(None)] * len(shape), 0
    if _ROWS:
        start, stop, total = _ROWS[-1]
        k, rest = divmod(shape[0], stop - start)
        if rest:
            raise ValueError(f"draw of {shape}: dim 0 is not {stop - start} batch rows")
        full[0], index[0] = total * k, slice(start * k, stop * k)
    if _TOKENS and len(shape) > 1:
        start, stop, length, padded = _TOKENS[-1]
        if shape[1] == stop - start and stop - start != padded:  # this rank's chunk
            full[1], index[1] = length, slice(min(start, length), min(stop, length))
            pad = shape[1] - (min(stop, length) - min(start, length))
        elif shape[1] == padded and padded != length:  # the whole padded sequence
            full[1], pad = length, padded - length
    if features is not None:
        start, stop, total = features
        full[-1], index[-1] = total, slice(start, stop)
    t = fn(tuple(full), generator=generator, device=device)[tuple(index)]
    if pad:
        t = torch.cat([t, t.new_zeros((t.shape[0], pad, *t.shape[2:]))], 1)
    return t


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            features: Optional[tuple[int, int, int]] = None) -> torch.Tensor:
    """Inverted dropout with the mask drawn from ``generator`` (on x's
    device): keep with probability ``1 - rate``, scale kept values by
    ``1 / (1 - rate)`` (the JAX package's ``bernoulli`` + ``where``).  The
    mask is :func:`draw`'s: on a mesh, one process's mask cut to this
    rank's part."""
    if rate == 0.0:
        return x
    keep = draw(torch.rand, x.shape, generator, x.device, features) < 1.0 - rate
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
