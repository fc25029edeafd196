"""MeshGraphNet baseline (EAGLE benchmark comparison model).

Counterpart of ``fluid_llm_tpu/models/baselines/mgn.py``
(``eagle/Models/MeshGraphNet.py:13-156``): encode (node one-hot + state,
edge distance + norm, running-stat normalizers) -> N residual
message-passing blocks -> MLP decoder of normalised diffs -> autoregressive
rollout with boundary-condition forcing (``next_state[mask] = state[:,
t][mask]``).  The JAX ``lax.scan`` is a Python loop over the T-1 steps
that threads the normalizer state; the input noise comes from an explicit
``torch.Generator``.  As in the JAX package, the noise is applied per
NORMAL/OUTPUT node (the reference's mask collapsed to one flag per sample).

Every gather and sum of a step goes through one
:class:`~fluid_llm_tpu_torch.ops.segment_ops.SegmentIndex` per edge column,
built once for the step, or once for the window when its edge list is one
broadcast tensor (``edges.stride(1) == 0``, as ``baselines_cli`` sends the
collate's single topology).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from fluid_llm_tpu_torch.models.baselines.base import (
    GNN,
    MLP,
    NODE_DISABLE,
    NODE_INPUT,
    NODE_NORMAL,
    NODE_OUTPUT,
    NODE_WALL,
    normalizer_apply,
    normalizer_init,
    normalizer_inverse,
)
from fluid_llm_tpu_torch.ops.segment_ops import SegmentIndex, gather_nodes


def edge_features(mesh_pos, senders, receivers, kernels: bool = True) -> torch.Tensor:
    """[sender - receiver distance, its norm] (``MeshGraphNet.py:70-76``)."""
    distance = gather_nodes(mesh_pos, senders, kernels) - gather_nodes(mesh_pos, receivers, kernels)
    norm = torch.sqrt((distance ** 2).sum(dim=-1, keepdim=True))
    return torch.cat([distance, norm], dim=-1)


def bc_mask_from_types(node_type) -> torch.Tensor:
    """INPUT | WALL | DISABLE forcing mask (``MeshGraphNet.py:45-47``)."""
    return ((node_type[..., NODE_INPUT] == 1) | (node_type[..., NODE_WALL] == 1)
            | (node_type[..., NODE_DISABLE] == 1))


def noise_mask_from_types(node_type) -> torch.Tensor:
    return (node_type[..., NODE_NORMAL] == 1) | (node_type[..., NODE_OUTPUT] == 1)


def edge_indexes(edges: torch.Tensor, n: int) -> list[tuple[SegmentIndex, SegmentIndex]]:
    """(senders, receivers) indexes for each step of ``edges`` (B, T, E, 2);
    one pair for every step where the time axis is a broadcast."""
    T = edges.shape[1]
    if T == 1 or edges.stride(1) == 0:
        return [(SegmentIndex(edges[:, 0, :, 0], n), SegmentIndex(edges[:, 0, :, 1], n))] * T
    return [(SegmentIndex(edges[:, t, :, 0], n), SegmentIndex(edges[:, t, :, 1], n))
            for t in range(T)]


class MGN(nn.Module):
    """``mgn_init`` / ``mgn_apply``: parameters ``fv``, ``fe``,
    ``processor.<i>`` (:class:`GNN`), ``decoder``; the normalizer state is
    kept outside the module (:meth:`init_norm`).  ``kernels = False``
    selects the segment ops' plain twins."""

    def __init__(self, state_size: int = 4, n_processor: int = 15,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.state_size = state_size
        self.kernels = True
        self.fv = MLP(9 + state_size, generator=generator)
        self.fe = MLP(3, generator=generator)
        self.processor = self._processor(n_processor, generator)
        self.decoder = MLP(128, state_size, layer_norm=False, generator=generator)

    def _processor(self, n_processor: int, generator) -> nn.ModuleList:
        return nn.ModuleList(GNN(generator=generator) for _ in range(n_processor))

    def process(self, V, E, senders, receivers) -> torch.Tensor:
        for block in self.processor:
            v, e = block(V, E, senders, receivers, self.kernels)
            V, E = V + v, E + e
        return V

    def init_norm(self, device=None) -> dict[str, dict[str, torch.Tensor]]:
        S = self.state_size
        return {"nodes": normalizer_init(9 + S, device=device),
                "edges": normalizer_init(3, device=device),
                "output": normalizer_init(S, device=device)}

    def apply(self, norm, mesh_pos, edges, state, node_type, *, train: bool = False,
              apply_noise: bool = False, noise_std: float = 2e-2,
              generator: Optional[torch.Generator] = None):
        """Window rollout (``MeshGraphNet.py:31-56``).

        mesh_pos: (B, T, N, 2); edges: (B, T, E, 2) int; state: (B, T, N, S);
        node_type: (B, T, N, 9) one-hot.  Returns (state_hat (B, T, N, S),
        output_hat (B, T-1, N, S), target, new norm); the new normalizer
        state is detached."""
        B, T, N, S = state.shape
        if apply_noise and generator is not None:
            nm = noise_mask_from_types(node_type[:, 0])
            noise = torch.randn(state[:, 0].shape, generator=generator, device=state.device,
                                dtype=state.dtype) * noise_std
            state0 = torch.where(nm[..., None], state[:, 0] + noise, state[:, 0])
            state = torch.cat([state0[:, None], state[:, 1:]], dim=1)

        target, norm_out = normalizer_apply(norm["output"], state[:, 1:] - state[:, :-1], train)
        prev, n_nodes, n_edges = state[:, 0], norm["nodes"], norm["edges"]
        states, outputs = [state[:, 0]], []
        for t, (senders, receivers) in enumerate(edge_indexes(edges[:, :-1], N)):
            v_in = torch.cat([prev, node_type[:, t].to(prev.dtype)], dim=-1)
            v_in, n_nodes = normalizer_apply(n_nodes, v_in, train)
            e_in = edge_features(mesh_pos[:, t], senders, receivers, self.kernels)
            e_in, n_edges = normalizer_apply(n_edges, e_in, train)

            V = self.process(self.fv(v_in), self.fe(e_in), senders, receivers)
            next_output = self.decoder(V)
            next_state = prev + normalizer_inverse(norm_out, next_output)
            mask = bc_mask_from_types(node_type[:, t + 1])
            prev = torch.where(mask[..., None], state[:, t + 1], next_state)
            states.append(prev)
            outputs.append(next_output)
        new_norm = {k: {kk: v.detach() for kk, v in s.items()}
                    for k, s in (("nodes", n_nodes), ("edges", n_edges), ("output", norm_out))}
        return torch.stack(states, dim=1), torch.stack(outputs, dim=1), target, new_norm

    forward = apply  # for torch.func.functional_call (baselines_cli --dtype bf16)


def mgn_loss(output_hat, target, mask, w_pressure: float = 0.1) -> torch.Tensor:
    """``eagle/train_mgn.py:64-72``: masked MSE on normalised diffs with
    pressure weighting; ``mask`` (B, T, N) zeroes ghosts, then a plain mean
    over everything."""
    m = mask[:, 1:, :, None].to(output_hat.dtype)
    loss_v = ((target[..., :2] * m - output_hat[..., :2] * m) ** 2).mean()
    loss_p = ((target[..., 2:] * m - output_hat[..., 2:] * m) ** 2).mean()
    return loss_v + w_pressure * loss_p
