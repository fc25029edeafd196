"""GATv2 on a static 4-neighbour pixel grid, scatter-free.

Counterpart of ``fluid_llm_tpu/ops/grid_gnn.py`` (``gatv2_conv`` and the
stack, :40-207).  The reference's MLPGNN decoder runs a torch-geometric
``GATv2Conv`` stack over a fixed grid graph (``src/models/layers/GNN/
GCN.py:6-52``); the fixed degree-<=5 topology (4 neighbours + self-loop)
makes each conv two dense linears and a five-slot attention per pixel:

    e_ij    = att . leaky_relu(lin_l(x_j) + lin_r(x_i))
    alpha_i = softmax_j(e_ij)   over j in N(i) u {i}
    out_i   = sum_j alpha_ij * lin_l(x_j)   (+ bias)

The slot attention runs in the hand-written kernels
(``ops/grid_gnn_fused.py``, forward and backward through its
``SlotAttention`` Function) on every CUDA call; ``lin_l``/``lin_r``, the
bias and the softplus between convs stay outside it, as in the JAX package.
Attention dropout in training (``grid_gnn.py:121-139``) needs the alphas
themselves: it takes :func:`slot_attention_dropout` (plain PyTorch, a
masked softmax over the 5 slots, a keep mask drawn from the caller's
``torch.Generator``), never the kernel, as the JAX package leaves its fused
path then (``grid_gnn.py:103``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fluid_llm_tpu_torch.models.common import linear
from fluid_llm_tpu_torch.ops.grid_gnn_fused import (
    SHIFTS, slot_attention, slot_attention_ref, slot_logits)


def slot_attention_dropout(xl, xr, att, heads: int, cdim: int, keep: torch.Tensor,
                           rate: float) -> torch.Tensor:
    """Slot attention with dropout on the attention weights: softmax over
    the 5 slots, alpha kept where ``keep`` (bool, (..., X, Y, S, H)) and
    scaled by ``1 / (1 - rate)`` (``grid_gnn.py:136-139``).  -> like xl."""
    logits, values = slot_logits(xl, xr, att, heads, cdim)
    alpha = torch.softmax(logits, dim=-2).to(xl.dtype)
    alpha = torch.where(keep, alpha / (1.0 - rate), torch.zeros((), dtype=alpha.dtype,
                                                                 device=alpha.device))
    out = torch.einsum("...shc,...sh->...hc", values, alpha)
    return out.reshape(*xl.shape[:-1], heads * cdim)


class GATv2Conv(nn.Module):
    """Keys follow the JAX pytree: ``lin_l``, ``lin_r``, ``att`` (heads, out),
    ``bias`` (concat layout)."""

    def __init__(self, in_dim: int, out_dim: int, heads: int = 1, bias: bool = True):
        super().__init__()
        self.heads, self.out_dim = heads, out_dim
        self.lin_l = nn.Linear(in_dim, heads * out_dim, bias=bias)
        self.lin_r = nn.Linear(in_dim, heads * out_dim, bias=bias)
        self.att = nn.Parameter(torch.empty(heads, out_dim))
        self.bias = nn.Parameter(torch.empty(heads * out_dim)) if bias else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Glorot-uniform weights and attention vector, zero biases."""
        for lin in (self.lin_l, self.lin_r):
            s = math.sqrt(6.0 / (lin.in_features + lin.out_features))
            lin.weight.uniform_(-s, s, generator=generator)
            if lin.bias is not None:
                lin.bias.zero_()
        s = math.sqrt(6.0 / (1 + self.out_dim))  # glorot over (1, heads, out)
        self.att.uniform_(-s, s, generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor, kernels: bool = True, dropout: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x: (..., X, Y, in_dim) -> (..., X, Y, heads*out_dim).  ``dropout``
        > 0 with a ``generator``: attention dropout, its keep mask drawn
        from the generator."""
        xl = linear(x, self.lin_l)  # source transform
        xr = linear(x, self.lin_r)  # target transform
        lead = x.shape[:-1]
        att = self.att.to(x.dtype)
        if dropout > 0.0 and generator is not None:
            shape = (*lead, len(SHIFTS), self.heads)
            keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - dropout
            out = slot_attention_dropout(xl, xr, att, self.heads, self.out_dim, keep, dropout)
        else:
            frames = (-1,) + xl.shape[-3:]
            attend = slot_attention if kernels else slot_attention_ref
            out = attend(xl.reshape(frames), xr.reshape(frames), att, self.heads, self.out_dim)
        out = out.reshape(*lead, self.heads * self.out_dim)
        if self.bias is not None:
            out = out + self.bias.to(x.dtype)
        return out


class GridGATStack(nn.Module):
    """``GCN_layers`` (``GNN/GCN.py:6-52``): GATv2 convs with softplus
    between them, then a single-head output conv."""

    def __init__(self, in_dim: int, hid_dim: int, out_dim: int, num_layers: int, heads: int = 1):
        super().__init__()
        if num_layers == 1:
            self.convs = nn.ModuleList()
            self.out = GATv2Conv(in_dim, out_dim, heads=1, bias=False)
            return
        dims = [in_dim] + [hid_dim] * (num_layers - 1)
        self.convs = nn.ModuleList(
            GATv2Conv(d, hid_dim // heads, heads=heads) for d in dims[:-1]
        )
        self.out = GATv2Conv(hid_dim, out_dim, heads=1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for conv in [*self.convs, self.out]:
            conv.reset_parameters(generator)

    def forward(self, x: torch.Tensor, kernels: bool = True, dropout: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x: (..., X, Y, in_dim) -> (..., X, Y, out_dim); attention dropout
        in every conv as :meth:`GATv2Conv.forward`."""
        for conv in self.convs:
            x = F.softplus(conv(x, kernels, dropout, generator))
        return self.out(x, kernels, dropout, generator)
