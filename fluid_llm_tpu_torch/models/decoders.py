"""Patch decoders: backbone hidden states -> per-pixel (Vx, Vy, P) diffs.

Counterpart of ``fluid_llm_tpu/models/decoders.py``:

- ``MLP``:    per-token MLP to patch_in_dim, raw-reinterpreted as the image
              (``patch_decoder.py:15-21`` + the raw view in ``model.py:151``).
- ``CNN``:    a Conv1d stack over the token axis (``patch_decoder.py:22-30``,
              ``CNN.py:4`` with ``conv_type='1d'``).  Reference quirks kept:
              the (bs, T, d) token stream is raw-reshaped (not transposed)
              to (bs, d, T) before the convs and back after
              (``patch_decoder.py:46-52``), which needs ``patch_in_dim ==
              llm_dim`` (checked here).  Frames are not decoded
              independently (``FluidLLM.predict_frame_diff``).
- ``MLPGNN``: the reference default: a 2-layer softplus MLP projects each
              token to out_patch x gnn_dim pixel features, ``F.fold`` (a
              reshape here) places them on the pixel grid, and a GATv2
              stack over the 4-neighbour grid refines to 3 channels
              (``GNN/decoders.py:196-248``); in training, with a generator,
              ``dropout`` acts on its attention weights.
"""

from __future__ import annotations

import torch
from torch import nn

from fluid_llm_tpu_torch.config import DecoderConfig
from fluid_llm_tpu_torch.data.ds_props import DSProps
from fluid_llm_tpu_torch.models.common import CNN, MLP
from fluid_llm_tpu_torch.ops.grid_gnn import GridGATStack
from fluid_llm_tpu_torch.ops.patching import fold_features


class PatchDecoder(nn.Module):
    def __init__(self, llm_dim: int, ds_props: DSProps, cfg: DecoderConfig):
        super().__init__()
        self.cfg, self.ds_props = cfg, ds_props
        self.mlp = self.cnn = self.gnn = None
        if cfg.type == "MLP":
            self.mlp = MLP(llm_dim, ds_props.patch_in_dim, cfg.hidden_dim, cfg.num_layers,
                           cfg.activation, zero_last=cfg.zero_last_layer)
        elif cfg.type == "CNN":
            if ds_props.patch_in_dim != llm_dim:
                raise ValueError(
                    "decoder type CNN requires patch_in_dim == llm_dim (got "
                    f"{ds_props.patch_in_dim} != {llm_dim}): the reference's raw reshape back "
                    "to the token stream (patch_decoder.py:52) is only shape-consistent then")
            self.cnn = CNN(llm_dim, ds_props.patch_in_dim, cfg.hidden_dim, cfg.num_layers,
                           cfg.activation, conv_dim=1, zero_last=cfg.zero_last_layer)
        elif cfg.type == "MLPGNN":
            opx, opy = ds_props.out_patch_size
            self.mlp = MLP(llm_dim, opx * opy * cfg.gnn_dim, cfg.mlp_hid_dim, 2, "softplus")
            self.gnn = GridGATStack(cfg.gnn_dim, cfg.gnn_hid_dim, 3, cfg.gnn_layers, cfg.gnn_heads)
        else:
            raise ValueError(f"Unknown patch decoder type: {cfg.type}")

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for part in (self.mlp, self.cnn, self.gnn):
            if part is not None:
                part.reset_parameters(generator)

    def forward(self, tokens: torch.Tensor, kernels: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """tokens: (bs, seq, N_patch, llm_dim) -> image (bs, seq, X, Y, 3).
        ``generator``: training; the MLPGNN's attention dropout draws from it."""
        bs, seq, n, d = tokens.shape
        X, Y = self.ds_props.out_tot_size
        if self.cnn is not None:
            # raw reshapes (bs, T, d) -> (bs, d, T) and back (``patch_decoder.py:44-52``)
            out = self.cnn(tokens.reshape(bs, d, seq * n))
            return out.reshape(bs, seq, X, Y, 3)
        h = self.mlp(tokens)
        if self.gnn is None:
            # reference quirk, reproduced: the flat (N_patch * patch_in_dim)
            # vector is raw-reinterpreted as (X, Y, 3) (``model.py:151``)
            return h.reshape(bs, seq, X, Y, 3)
        grid = fold_features(h, self.ds_props, self.cfg.gnn_dim)  # (bs, seq, X, Y, gnn_dim)
        return self.gnn(grid, kernels, self.cfg.dropout, generator)
