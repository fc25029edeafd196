"""Patch decoders: backbone hidden states -> per-pixel (Vx, Vy, P) diffs.

Counterpart of ``fluid_llm_tpu/models/decoders.py``; the ``MLP`` and
``MLPGNN`` types are ported (``CNN`` comes later):

- ``MLP``:    per-token MLP to patch_in_dim, raw-reinterpreted as the image
              (``patch_decoder.py:15-21`` + the raw view in ``model.py:151``).
- ``MLPGNN``: the reference default: a 2-layer softplus MLP projects each
              token to out_patch x gnn_dim pixel features, ``F.fold`` (a
              reshape here) places them on the pixel grid, and a GATv2
              stack over the 4-neighbour grid refines to 3 channels
              (``GNN/decoders.py:196-248``).
"""

from __future__ import annotations

import torch
from torch import nn

from fluid_llm_tpu.config import DecoderConfig
from fluid_llm_tpu_torch.data.ds_props import DSProps
from fluid_llm_tpu_torch.models.common import MLP
from fluid_llm_tpu_torch.ops.grid_gnn import GridGATStack
from fluid_llm_tpu_torch.ops.patching import fold_features


class PatchDecoder(nn.Module):
    def __init__(self, llm_dim: int, ds_props: DSProps, cfg: DecoderConfig):
        super().__init__()
        self.cfg, self.ds_props = cfg, ds_props
        if cfg.type == "MLP":
            self.mlp = MLP(llm_dim, ds_props.patch_in_dim, cfg.hidden_dim, cfg.num_layers,
                           cfg.activation, zero_last=cfg.zero_last_layer)
            self.gnn = None
        elif cfg.type == "MLPGNN":
            opx, opy = ds_props.out_patch_size
            self.mlp = MLP(llm_dim, opx * opy * cfg.gnn_dim, cfg.mlp_hid_dim, 2, "softplus")
            self.gnn = GridGATStack(cfg.gnn_dim, cfg.gnn_hid_dim, 3, cfg.gnn_layers, cfg.gnn_heads)
        else:
            raise ValueError(f"patch decoder {cfg.type!r}: only MLP and MLPGNN are ported")

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mlp.reset_parameters(generator)
        if self.gnn is not None:
            self.gnn.reset_parameters(generator)

    def forward(self, tokens: torch.Tensor, kernels: bool = True,
                train: bool = False) -> torch.Tensor:
        """tokens: (bs, seq, N_patch, llm_dim) -> image (bs, seq, X, Y, 3)."""
        if train and self.gnn is not None and self.cfg.dropout > 0:
            raise NotImplementedError("MLPGNN attention dropout in training is not ported "
                                      "(decoder_params.dropout must be 0)")
        bs, seq = tokens.shape[:2]
        X, Y = self.ds_props.out_tot_size
        h = self.mlp(tokens)
        if self.gnn is None:
            # reference quirk, reproduced: the flat (N_patch * patch_in_dim)
            # vector is raw-reinterpreted as (X, Y, 3) (``model.py:151``)
            return h.reshape(bs, seq, X, Y, 3)
        grid = fold_features(h, self.ds_props, self.cfg.gnn_dim)  # (bs, seq, X, Y, gnn_dim)
        return self.gnn(grid, kernels)
