"""GATv2 on a static 4-neighbour pixel grid, scatter-free.

Counterpart of ``fluid_llm_tpu/ops/grid_gnn.py`` (``gatv2_conv`` and the
stack, :40-207).  The reference's MLPGNN decoder runs a torch-geometric
``GATv2Conv`` stack over a fixed grid graph (``src/models/layers/GNN/
GCN.py:6-52``); the fixed degree-<=5 topology (4 neighbours + self-loop)
makes each conv two dense linears and a five-slot attention per pixel:

    e_ij    = att . leaky_relu(lin_l(x_j) + lin_r(x_i))
    alpha_i = softmax_j(e_ij)   over j in N(i) u {i}
    out_i   = sum_j alpha_ij * lin_l(x_j)   (+ bias)

The slot attention runs in the hand-written kernel
(``ops/grid_gnn_fused.py``) on every CUDA call; ``lin_l``/``lin_r``, the
bias and the softplus between convs stay outside it, as in the JAX package.
The attention-dropout path is training only and comes later.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fluid_llm_tpu_torch.models.common import linear
from fluid_llm_tpu_torch.ops.grid_gnn_fused import fused_slot_attention, slot_attention_ref


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

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        """x: (..., X, Y, in_dim) -> (..., X, Y, heads*out_dim)."""
        xl = linear(x, self.lin_l)  # source transform
        xr = linear(x, self.lin_r)  # target transform
        lead = x.shape[:-1]
        frames = (-1,) + xl.shape[-3:]
        attend = fused_slot_attention if kernels else slot_attention_ref
        out = attend(xl.reshape(frames), xr.reshape(frames), self.att.to(x.dtype),
                     self.heads, self.out_dim)
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

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        """x: (..., X, Y, in_dim) -> (..., X, Y, out_dim)."""
        for conv in self.convs:
            x = F.softplus(conv(x, kernels))
        return self.out(x, kernels)
