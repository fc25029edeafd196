"""GraphViT baseline: GNN encoder, cluster pooling, transformer, retrieve.

Counterpart of ``fluid_llm_tpu/models/baselines/graphvit.py``
(``eagle/Models/GraphViT.py:12-227``):

- sin/cos positional encoding of absolute node positions and of positions
  relative to the (constrained k-means) cluster centres (``:189-227``);
- GNN encoder: node/edge MLPs and 4 residual message-passing blocks with the
  positional features concatenated at each block's input (``:156-186``);
- pooling: a GRU over each cluster's members, whose hidden state at the
  last real member becomes the cluster token (``:98-126``);
- 4 pre-LN multi-head attention blocks over the tokens, ghost clusters
  masked out of the keys except the diagonal (``:44-51,73-95``);
- retrieve: tokens broadcast back to their member nodes, one GNN block and
  a tanh MLP head (``:129-153``);
- the residual state update with boundary forcing at each step
  (``:36-63``), the JAX ``lax.scan`` as a Python loop.

The GRU (gate order r, z, n, as torch's ``nn.GRU``), the attention (logits
and softmax in f32, ``-1e30`` where masked, probabilities cast back) and the
LayerNorms (statistics in f32) are plain torch operations, as they are XLA
operations outside any Pallas kernel in the JAX package.  Every computation
follows the parameters' dtype, so ``baselines_cli --dtype bf16`` runs the
network in bf16 over f32 masters; the positional encoding and the
position gathers stay f32.

Every cluster gather and sum goes through ``ops/segment_ops`` (the CUDA
segment kernels on the card) with one
:class:`~fluid_llm_tpu_torch.ops.segment_ops.SegmentIndex` of the member ids
per cluster table, built once for the window when the table is broadcast
over its time axis: gathers of positions (F 2), node features (F 128) and
the node encoding (F 64); sums of the relative encoding (F 32) and of the
tokens (F ``w_size``).  Ghost member slots (``cluster_mask`` 0) carry the
id ``N``, so the gathers give them zero rows and the sums drop them, on
every dtype.  The JAX f32 path instead pads the node table with one row,
gathers the ghost node's row into those slots and scatters with
``.at[idx].set`` (``:109-111,315-317``); on real rows the two are equal,
since each real node belongs to exactly one cluster, the GRU's picked state
lies at the last real member, and ghost clusters are masked out of the
attention's keys.  Only the ghost node's row differs, which the loss masks.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from fluid_llm_tpu_torch.models.baselines.base import GNN, MLP, torch_linear
from fluid_llm_tpu_torch.models.baselines.mgn import (
    bc_mask_from_types,
    edge_features,
    edge_indexes,
    noise_mask_from_types,
)
from fluid_llm_tpu_torch.ops.segment_ops import SegmentIndex, gather_nodes, segment_sum_nodes

POS_START = -3
POS_LENGTH = 8
POS_DIM = 4 * POS_LENGTH  # embedding of a 2-D point: 2 coords x (cos, sin) x lengths


def pos_embed(pos: torch.Tensor) -> torch.Tensor:
    """``GraphViT.py:218-227``: multi-frequency sin/cos features,
    (..., d) -> (..., d * 2 * POS_LENGTH)."""
    index = torch.arange(POS_START, POS_START + POS_LENGTH, dtype=torch.float32,
                         device=pos.device)
    ang = pos[..., None] * ((2.0 ** index) * math.pi)
    emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
    return emb.reshape(*pos.shape[:-1], pos.shape[-1] * 2 * POS_LENGTH)


def member_index(cluster: torch.Tensor, cluster_mask: torch.Tensor, n: int) -> SegmentIndex:
    """The member ids of a cluster table (B, C, K) as one index over ``n``
    node rows: real slots their node, ghost slots ``n`` (dropped)."""
    ids = torch.where(cluster_mask > 0, cluster, n)
    return SegmentIndex(ids.reshape(ids.shape[0], -1), n)


def member_indexes(cluster: torch.Tensor, cluster_mask: torch.Tensor,
                   n: int) -> list[SegmentIndex]:
    """One member index for each step of (B, T, C, K) tables; one for every
    step where both are broadcast over the time axis."""
    T = cluster.shape[1]
    if T == 1 or (cluster.stride(1) == 0 and cluster_mask.stride(1) == 0):
        return [member_index(cluster[:, 0], cluster_mask[:, 0], n)] * T
    return [member_index(cluster[:, t], cluster_mask[:, t], n) for t in range(T)]


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """``_ln``: statistics in f32, cast back, then the affine map."""
    return F.layer_norm(x.float(), x.shape[-1:], None, None, 1e-5).to(x.dtype) * ln.weight \
        + ln.bias


def _uniform(shape, bound: float, generator) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=generator))


class GRU(nn.Module):
    """``gru_init`` / ``gru_scan``: torch's GRU cell (gates r, z, n) with
    the JAX layout, ``w_ih`` (In, 3H) and ``w_hh`` (H, 3H), computed in
    their dtype; an explicit loop over the sequence."""

    def __init__(self, input_size: int, hidden_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(hidden_size)
        self.hidden_size = hidden_size
        self.w_ih = _uniform((input_size, 3 * hidden_size), bound, generator)
        self.w_hh = _uniform((hidden_size, 3 * hidden_size), bound, generator)
        self.b_ih = _uniform((3 * hidden_size,), bound, generator)
        self.b_hh = _uniform((3 * hidden_size,), bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, L, In) -> every step's hidden state (B, L, H)."""
        x = x.to(self.w_ih.dtype)
        gi = x @ self.w_ih + self.b_ih  # the input's gates of every step at once
        h = x.new_zeros(x.shape[0], self.hidden_size)
        outs = []
        for t in range(x.shape[1]):
            i_r, i_z, i_n = gi[:, t].chunk(3, dim=-1)
            h_r, h_z, h_n = (h @ self.w_hh + self.b_hh).chunk(3, dim=-1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            n = torch.tanh(i_n + r * h_n)
            h = (1 - z) * n + z * h
            outs.append(h)
        return torch.stack(outs, dim=1)


class MultiheadAttention(nn.Module):
    """``mha_init`` / ``mha_apply``: torch's packed ``in_proj`` in the JAX
    layout ``in_w`` (E, 3E), Xavier-uniform, ``in_b`` zeros, and ``out``."""

    def __init__(self, embed_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_w = _uniform((embed_dim, 3 * embed_dim), math.sqrt(3.0 / embed_dim), generator)
        self.in_b = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out = torch_linear(embed_dim, embed_dim, generator)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor, n_heads: int) -> torch.Tensor:
        """x (B, L, E); attn_mask (B, L, L) bool, True where disallowed."""
        x = x.to(self.in_w.dtype)
        B, L, E = x.shape
        hd = E // n_heads
        q, k, v = (t.reshape(B, L, n_heads, hd)
                   for t in (x @ self.in_w + self.in_b).chunk(3, dim=-1))
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
        logits = logits.masked_fill(attn_mask[:, None], -1e30)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, L, E))


class AttentionBlock(nn.Module):
    """One pre-LN block over the cluster tokens (``GraphViT.py:73-95``)."""

    def __init__(self, w_size: int, embed_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ln1 = nn.LayerNorm(w_size)
        self.mha = MultiheadAttention(embed_dim, generator)
        self.linear = torch_linear(embed_dim, w_size, generator)
        self.ln2 = nn.LayerNorm(w_size)
        self.mlp = MLP(w_size, w_size, n_hidden=1, hidden_size=w_size, layer_norm=False,
                       generator=generator)

    def forward(self, W, cluster_enc, attn_mask, n_heads: int):
        w1 = layer_norm(W, self.ln1)
        w2 = self.mha(torch.cat([w1, cluster_enc.to(w1.dtype)], dim=-1), attn_mask, n_heads)
        w3 = W + self.linear(w2)
        return w3 + self.mlp(layer_norm(w3, self.ln2))


class GraphViT(nn.Module):
    """``graphvit_init`` / ``graphvit_apply``: parameters under the JAX
    tree's names (``encoder_node``, ``encoder_edge``, ``encoder_gn.<i>``,
    ``pool_gru``, ``pool_mlp``, ``attention.<i>``, ``ln``, ``retrieve_gnn``,
    ``final_mlp.<i>``), so ``weights.from_jax_params`` bridges them.  No
    normalizer.  ``kernels = False`` selects the segment ops' plain twins."""

    def __init__(self, state_size: int = 4, w_size: int = 512, n_attention: int = 4,
                 nb_gn: int = 4, n_heads: int = 4, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_heads = n_heads
        self.kernels = True
        node_size = 128 + POS_DIM * 2
        self.encoder_node = MLP(9 + state_size, 128, n_hidden=1, layer_norm=False,
                                generator=generator)
        self.encoder_edge = MLP(3, 128, n_hidden=1, layer_norm=False, generator=generator)
        self.encoder_gn = nn.ModuleList(
            GNN(node_size=node_size, edge_size=128, output_size=128, layer_norm=True,
                generator=generator) for _ in range(nb_gn))
        self.pool_gru = GRU(node_size, w_size, generator)
        self.pool_mlp = MLP(w_size, w_size, n_hidden=1, layer_norm=False, generator=generator)
        self.attention = nn.ModuleList(AttentionBlock(w_size, w_size + POS_DIM, generator)
                                       for _ in range(n_attention))
        self.ln = nn.LayerNorm(w_size)
        self.retrieve_gnn = GNN(node_size=w_size + node_size, output_size=128,
                                generator=generator)
        self.final_mlp = nn.ModuleList([torch_linear(128, 128, generator),
                                        torch_linear(128, 128, generator),
                                        torch_linear(128, state_size, generator)])

    def positional_encoder(self, mesh_pos, index: SegmentIndex, cluster_mask):
        """``GraphViT.py:196-216``: (node encoding (B, N, 2 POS_DIM), cluster
        encoding (B, C, POS_DIM)), both f32."""
        B, C, K = cluster_mask.shape
        N = mesh_pos.shape[1]
        pos_by_cluster = gather_nodes(mesh_pos, index, self.kernels).reshape(B, C, K, 2)
        centers = (pos_by_cluster * cluster_mask[..., None]).sum(dim=-2)
        centers = centers / (cluster_mask.sum(dim=-1, keepdim=True) + 1e-8)
        rel_emb = pos_embed(centers[:, :, None] - pos_by_cluster).reshape(B, C * K, POS_DIM)
        scat = segment_sum_nodes(rel_emb, index, N, self.kernels)
        return torch.cat([pos_embed(mesh_pos), scat], dim=-1), pos_embed(centers)

    def encode(self, mesh_pos, senders, receivers, state, node_type, pos_enc):
        """``GraphViT.py:156-186``."""
        E = self.encoder_edge(edge_features(mesh_pos, senders, receivers, self.kernels))
        V = self.encoder_node(torch.cat([state, node_type.to(state.dtype)], dim=-1))
        pos_enc = pos_enc.to(V.dtype)
        for block in self.encoder_gn:
            v, e = block(torch.cat([V, pos_enc], dim=-1), E, senders, receivers, self.kernels)
            V, E = V + v, E + e
        return V, E

    def pool(self, V, index: SegmentIndex, pos_enc, cluster_mask):
        """``GraphViT.py:98-126``: the GRU over each cluster's members, its
        state at the last real member (slot K-1 for a ghost cluster)."""
        B, C, K = cluster_mask.shape
        v_by = gather_nodes(V, index, self.kernels).reshape(B * C, K, -1)
        p_by = gather_nodes(pos_enc.to(V.dtype), index, self.kernels).reshape(B * C, K, -1)
        out = self.pool_gru(torch.cat([v_by, p_by], dim=-1))
        idx = cluster_mask.sum(dim=-1).long().reshape(B * C) - 1
        idx = torch.where(idx == -1, K - 1, idx)
        picked = out[torch.arange(B * C, device=out.device), idx]
        return self.pool_mlp(picked[:, None])[:, 0].reshape(B, C, -1)

    def retrieve(self, W, V, index: SegmentIndex, pos_enc, senders, receivers, E, K: int):
        """``GraphViT.py:129-153``: each token summed into its members' rows
        (set == sum on real rows), one GNN block, the tanh head."""
        B, C, w = W.shape
        w_rep = W.to(V.dtype)[:, :, None].expand(B, C, K, w).reshape(B, C * K, w)
        w_nodes = segment_sum_nodes(w_rep, index, V.shape[1], self.kernels)
        nodes = torch.cat([V, w_nodes, pos_enc.to(V.dtype)], dim=-1)
        h, _ = self.retrieve_gnn(nodes, E, senders, receivers, self.kernels)
        for i, lin in enumerate(self.final_mlp):
            h = lin(h)
            if i < 2:
                h = torch.tanh(h)
        return h

    def step(self, mesh_pos, senders, receivers, state, node_type, index: SegmentIndex,
             cluster_mask):
        """One diff prediction for the current state (``GraphViT.py:38-55``)."""
        C, K = cluster_mask.shape[-2:]
        node_enc, cluster_enc = self.positional_encoder(mesh_pos, index, cluster_mask)
        V, E = self.encode(mesh_pos, senders, receivers, state, node_type, node_enc)
        W = self.pool(V, index, node_enc, cluster_mask)
        ghost = cluster_mask.sum(dim=-1) == 0  # (B, C): out of the keys, diagonal kept
        eye = torch.eye(C, dtype=torch.bool, device=ghost.device)
        attn_mask = ghost[:, None, :] & ~eye[None]
        for block in self.attention:
            W = block(W, cluster_enc, attn_mask, self.n_heads)
        W = layer_norm(W, self.ln)
        return self.retrieve(W, V, index, node_enc, senders, receivers, E, K)

    def apply(self, mesh_pos, edges, state, node_type, cluster, cluster_mask, *,
              apply_noise: bool = False, noise_std: float = 0.0,
              generator: Optional[torch.Generator] = None):
        """Window rollout (``GraphViT.py:27-71``).

        mesh_pos (B, T, N, 2); edges (B, T, E, 2); state (B, T, N, S);
        node_type (B, T, N, 9); cluster (B, T, C, K) node ids; cluster_mask
        (B, T, C, K) 1/0.  Returns (state_hat (B, T, N, S), output_hat
        (B, T-1, N, S), target (B, T-1, N, S))."""
        N = state.shape[2]
        if apply_noise and generator is not None and noise_std > 0:
            nm = noise_mask_from_types(node_type[:, 0])
            noise = torch.randn(state[:, 0].shape, generator=generator, device=state.device,
                                dtype=state.dtype) * noise_std
            state0 = torch.where(nm[..., None], state[:, 0] + noise, state[:, 0])
            state = torch.cat([state0[:, None], state[:, 1:]], dim=1)
        prev = state[:, 0]
        states, outputs, targets = [prev], [], []
        steps = zip(edge_indexes(edges[:, :-1], N),
                    member_indexes(cluster[:, :-1], cluster_mask[:, :-1], N))
        for t, ((senders, receivers), index) in enumerate(steps):
            out = self.step(mesh_pos[:, t], senders, receivers, prev, node_type[:, t], index,
                            cluster_mask[:, t])
            targets.append(state[:, t + 1] - prev)
            mask = bc_mask_from_types(node_type[:, t + 1])
            prev = torch.where(mask[..., None], state[:, t + 1], prev + out)
            states.append(prev)
            outputs.append(out)
        return torch.stack(states, dim=1), torch.stack(outputs, dim=1), torch.stack(targets, dim=1)

    forward = apply


def graphvit_loss(output_hat, target, mask, alpha: float = 0.1) -> torch.Tensor:
    """``eagle/train_graphvit.py:79-88``: x10-scaled masked MSE, ``alpha`` on
    the pressure channels."""
    m = mask[:, 1:, :, None].to(output_hat.dtype)
    output_hat, target = output_hat * 10, target * 10
    loss_v = ((target[..., :2] * m - output_hat[..., :2] * m) ** 2).mean()
    loss_p = ((target[..., 2:] * m - output_hat[..., 2:] * m) ** 2).mean()
    return loss_v + alpha * loss_p
