"""GATNet: vertex/edge MLP embedders and edge-featured GAT attention layers.

Counterpart of ``fluid_llm_tpu/models/baselines/gatnet.py``
(``src/models/layers/GNN/GATConv.py:7-49``; upstream only the unused
``GNN_encoder`` variant builds it).  Attention follows torch-geometric's
``GATConv`` with ``edge_dim``: per-edge logits ``att_src . x_src + att_dst .
x_dst + att_edge . e`` with LeakyReLU (0.2) and a softmax over each
destination's incoming edges (``edges[..., 1]``, unsorted), shifted by the
global maximum; softplus between layers.

The softmax's two sums (F = heads, and F = heads x out_dim for the
numerator) and the endpoint gathers go through ``ops/segment_ops`` (the
CUDA segment kernels on the card) with one
:class:`~fluid_llm_tpu_torch.ops.segment_ops.SegmentIndex` per edge column.
The JAX package gathers with ``take_along_axis`` (clamping), which equals
the segment gather on every in-range id.  Parameters keep the JAX names and
layouts (``lin`` (in, heads x out_dim), ``att_*`` (heads, out_dim)).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from fluid_llm_tpu_torch.models.baselines.base import MLP
from fluid_llm_tpu_torch.ops.segment_ops import SegmentIndex, gather_nodes, segment_sum_nodes


@dataclass(frozen=True)
class GATNetConfig:
    mlp_layers: int = 2
    mlp_hid_dim: int = 64
    gnn_layers: int = 3
    gnn_dim: int = 32
    gnn_heads: int = 2


def _glorot(shape, generator) -> nn.Parameter:
    s = math.sqrt(6.0 / (shape[0] + shape[-1]))
    return nn.Parameter(torch.empty(shape).uniform_(-s, s, generator=generator))


class GATEdgeConv(nn.Module):
    """``gat_edge_conv_init`` / ``gat_edge_conv_apply``."""

    def __init__(self, in_dim: int, out_dim: int, heads: int, edge_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads, self.out_dim = heads, out_dim
        self.lin = _glorot((in_dim, heads * out_dim), generator)
        self.lin_edge = _glorot((edge_dim, heads * out_dim), generator)
        self.att_src = _glorot((heads, out_dim), generator)
        self.att_dst = _glorot((heads, out_dim), generator)
        self.att_edge = _glorot((heads, out_dim), generator)
        self.bias = nn.Parameter(torch.zeros(heads * out_dim))

    def forward(self, V, E, src: SegmentIndex, dst: SegmentIndex, kernels: bool = True):
        """V (B, N, F); E (B, Ne, Fe); src/dst: the indexes of ``edges[...,
        0]`` / ``edges[..., 1]`` -> (B, N, heads x out_dim)."""
        B, N, _ = V.shape
        H, C = self.heads, self.out_dim
        x = V @ self.lin
        e = (E @ self.lin_edge).reshape(B, E.shape[1], H, C)
        x_src = gather_nodes(x, src, kernels).reshape(e.shape)
        x_dst = gather_nodes(x, dst, kernels).reshape(e.shape)
        alpha = ((x_src * self.att_src).sum(-1) + (x_dst * self.att_dst).sum(-1)
                 + (e * self.att_edge).sum(-1))  # (B, Ne, H)
        alpha = F.leaky_relu(alpha, 0.2)
        alpha = torch.exp(alpha - alpha.amax(dim=1, keepdim=True).detach())
        denom = segment_sum_nodes(alpha, dst, N, kernels)  # (B, N, H)
        num = segment_sum_nodes(alpha[..., None] * x_src, dst, N, kernels)  # (B, N, H, C)
        return (num / (denom[..., None] + 1e-16)).reshape(B, N, H * C) + self.bias


class GATNet(nn.Module):
    """``gatnet_init`` / ``gatnet_apply`` (``GATConv.py:14-49``): the first
    layer gnn_dim -> gnn_dim x heads, hidden layers from the concatenated
    width, a single-head output layer; parameters ``vertx_mlp``,
    ``edge_mlp``, ``layers.<i>``.  ``kernels = False`` selects the segment
    ops' plain twins."""

    def __init__(self, vertex_dim: int, edge_dim: int, out_dim: int,
                 cfg: GATNetConfig = GATNetConfig(), generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernels = True
        d, h = cfg.gnn_dim, cfg.gnn_heads
        mlp = dict(layer_norm=False, n_hidden=cfg.mlp_layers, hidden_size=cfg.mlp_hid_dim,
                   generator=generator)
        self.vertx_mlp = MLP(vertex_dim, d, **mlp)
        self.edge_mlp = MLP(edge_dim, d, **mlp)
        layers = [GATEdgeConv(d, d, h, d, generator)]
        layers += [GATEdgeConv(d * h, d, h, d, generator) for _ in range(cfg.gnn_layers - 2)]
        layers.append(GATEdgeConv(d * h, out_dim, 1, d, generator))
        self.layers = nn.ModuleList(layers)

    def forward(self, vert_in, edge_in, edges) -> torch.Tensor:
        """vert_in (B, N, vertex_dim); edge_in (B, Ne, edge_dim); edges (B,
        Ne, 2) [src, dst] -> (B, N, out_dim)."""
        N = vert_in.shape[1]
        src, dst = SegmentIndex(edges[..., 0], N), SegmentIndex(edges[..., 1], N)
        V, E = self.vertx_mlp(vert_in), self.edge_mlp(edge_in)
        for i, layer in enumerate(self.layers):
            V = layer(V, E, src, dst, self.kernels)
            if i < len(self.layers) - 1:
                V = F.softplus(V)
        return V
