"""Shared baseline blocks: MLP, message-passing GNN, GAT, running Normalizer.

Counterpart of ``fluid_llm_tpu/models/baselines/base.py``
(``eagle/Models/Base.py``):

- :class:`MLP`: Linear/ReLU stack with an optional final LayerNorm
  (``Base.py:6-24``), computed in the parameters' dtype.
- :class:`GNN`: edge MLP over [sender, receiver, edge] -> segment sum back
  to the *sender* index -> node MLP over [node, edge_sum]
  (``Base.py:27-49``).
- :class:`GAT` / :class:`MultiHeadGAT`: softmax-free attention normalised
  by the segment-summed exp weights (``Base.py:52-86``).
- ``normalizer_*``: the running-stat accumulator (``Base.py:89-118``) as an
  explicit state of f32 tensors, with the reference's quirk: it accumulates
  per-call *means* but counts per-call *batch sizes*.

Parameter names follow the JAX trees (``layers.<i>``, ``ln``, ``f_edge``,
``f_node``, ``att``, ``heads``), so ``weights.from_jax_params`` bridges
them.  Linears are drawn as torch's ``nn.Linear`` default (uniform in
``±1/sqrt(fan_in)``, weight and bias) from the given generator.  Gathers
and sums go through ``ops/segment_ops`` with the ids of a
:class:`~fluid_llm_tpu_torch.ops.segment_ops.SegmentIndex`; ``kernels=False``
selects the plain twins.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from fluid_llm_tpu_torch.ops.segment_ops import gather_nodes, segment_sum_nodes

# node-type codes (``eagle/Models/MeshGraphNet.py:7-11``)
NODE_NORMAL = 0
NODE_INPUT = 4
NODE_OUTPUT = 5
NODE_WALL = 6
NODE_DISABLE = 2


def torch_linear(d_in: int, d_out: int, generator: Optional[torch.Generator],
                 bias: bool = True) -> nn.Linear:
    """``nn.Linear`` drawn uniform in ``±1/sqrt(d_in)`` from ``generator``."""
    lin = nn.Linear(d_in, d_out, bias=bias)
    bound = 1.0 / math.sqrt(d_in)
    with torch.no_grad():
        for p in lin.parameters():
            p.uniform_(-bound, bound, generator=generator)
    return lin


class MLP(nn.Module):
    """``Base.py:6-21``: input -> hidden, (n_hidden - 1) hiddens, -> output,
    ReLU between, then LayerNorm (eps 1e-5, in f32) if ``layer_norm``."""

    def __init__(self, input_size: int, output_size: int = 128, layer_norm: bool = True,
                 n_hidden: int = 2, hidden_size: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if hidden_size == 0:
            sizes = [input_size, output_size]
        else:
            sizes = [input_size] + [hidden_size] * n_hidden + [output_size]
        self.layers = nn.ModuleList(torch_linear(a, b, generator)
                                    for a, b in zip(sizes[:-1], sizes[1:]))
        self.ln = nn.LayerNorm(output_size, eps=1e-5) if layer_norm and hidden_size else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.layers[0].weight.dtype)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        if self.ln is not None:
            x = F.layer_norm(x.float(), x.shape[-1:], None, None, 1e-5).to(x.dtype) \
                * self.ln.weight + self.ln.bias
        return x


class GNN(nn.Module):
    """One message-passing block (``Base.py:27-49``)."""

    def __init__(self, n_hidden: int = 2, node_size: int = 128, edge_size: int = 128,
                 output_size: Optional[int] = None, layer_norm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        output_size = output_size or node_size
        self.f_edge = MLP(edge_size + node_size * 2, edge_size, layer_norm=layer_norm,
                          n_hidden=n_hidden, generator=generator)
        self.f_node = MLP(edge_size + node_size, output_size, layer_norm=layer_norm,
                          n_hidden=n_hidden, generator=generator)

    def forward(self, V, E, senders, receivers, kernels: bool = True):
        """V: (B, N, Fv); E: (B, Ne, Fe); senders/receivers: the ids of
        ``edges[..., 0]`` / ``edges[..., 1]`` (tensors or SegmentIndex) ->
        (node update, edge update)."""
        s = gather_nodes(V, senders, kernels)
        r = gather_nodes(V, receivers, kernels)
        edge_emb = self.f_edge(torch.cat([s, r, E], dim=-1))
        edge_sum = segment_sum_nodes(edge_emb, senders, V.shape[-2], kernels)
        node_emb = self.f_node(torch.cat([V, edge_sum], dim=-1))
        return node_emb, edge_emb


class GAT(nn.Module):
    """One attention head (``Base.py:52-86``): exp-weighted segment sum at
    the sender index."""

    def __init__(self, node_size: int, output_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.f_edge = torch_linear(node_size, output_size, generator, bias=False)
        self.att = torch_linear(output_size * 2 + 128, 1, generator)

    def forward(self, V, E, senders, receivers, kernels: bool = True):
        h_sender = self.f_edge(gather_nodes(V, senders, kernels))
        h_receiver = self.f_edge(gather_nodes(V, receivers, kernels))
        attention = F.leaky_relu(self.att(torch.cat([h_sender, h_receiver, E], dim=-1)), 0.2)
        attention = torch.exp(attention - attention.amax(dim=1, keepdim=True))
        n = V.shape[-2]
        numerator = segment_sum_nodes(attention * h_sender, senders, n, kernels)
        denominator = segment_sum_nodes(attention, senders, n, kernels)
        return numerator / (denominator + 1e-8)


class MultiHeadGAT(nn.Module):
    """``n_heads`` heads of ``output_size // n_heads`` channels, concatenated."""

    def __init__(self, node_size: int, output_size: int, n_heads: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if output_size % n_heads:
            raise ValueError(f"output_size {output_size} is not a multiple of {n_heads} heads")
        self.heads = nn.ModuleList(GAT(node_size, output_size // n_heads, generator)
                                   for _ in range(n_heads))

    def forward(self, V, E, senders, receivers, kernels: bool = True):
        return torch.cat([h(V, E, senders, receivers, kernels) for h in self.heads], dim=-1)


# -- running-stat Normalizer -------------------------------------------------


def normalizer_init(size: int, init_std: float = 1.0, device=None) -> dict[str, torch.Tensor]:
    """``init_std=1`` as the MeshGraphNet file's variant
    (``MeshGraphNet.py:118-125``); ``Base.py:89-98`` inits std to 0."""
    z = torch.zeros(size, device=device)
    return {"acc": z, "acc_sq": z.clone(), "count": torch.zeros((), device=device),
            "mean": z.clone(), "std": torch.full((size,), float(init_std), device=device)}


def normalizer_apply(state: dict, x: torch.Tensor, update: bool):
    """``Base.py:102-115``: with ``update`` (torch's ``.training``)
    accumulate the batch means and refresh mean/std, frozen once ``count``
    reaches 1e7; returns ``((x - mean) / (std + 1e-8), state)``."""
    if update:
        flat = x.reshape(-1, x.shape[-2], x.shape[-1])
        below_cap = state["count"] < 1e7
        inc = torch.where(below_cap, float(flat.shape[0]), 0.0)
        add = below_cap.to(x.dtype)
        acc = state["acc"] + add * flat.mean(dim=(0, 1))
        acc_sq = state["acc_sq"] + add * (flat ** 2).mean(dim=(0, 1))
        count = state["count"] + inc
        mean = acc / (count + 1e-8)
        std = torch.sqrt(acc_sq / (count + 1e-8) - mean ** 2)
        state = {"acc": acc, "acc_sq": acc_sq, "count": count,
                 "mean": torch.where(below_cap, mean, state["mean"]),
                 "std": torch.where(below_cap, std, state["std"])}
    return (x - state["mean"]) / (state["std"] + 1e-8), state


def normalizer_inverse(state: dict, x: torch.Tensor) -> torch.Tensor:
    return x * state["std"] + state["mean"]


def load_norm(like: dict, norm: dict) -> dict:
    """``norm`` (a saved or bridged normalizer tree) as f32 tensors on the
    device of ``like`` (a model's ``init_norm()``); raises unless both have
    the same normalizers, the same keys and the same shapes."""
    def shapes(tree):
        return {name: {k: tuple(v.shape) for k, v in s.items()} for name, s in tree.items()}

    if shapes(like) != shapes(norm):
        raise ValueError(f"normalizer state {shapes(norm)} does not match {shapes(like)}")
    return {name: {k: v.to(like[name][k].device, torch.float32) for k, v in s.items()}
            for name, s in norm.items()}
