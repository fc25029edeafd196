"""Input embedding stack: MLP patch encoder + learned 3-axis positions.

Counterpart of ``fluid_llm_tpu/models/embeddings.py`` (``patch_encoder``,
``pos_embed`` :48-66, ``input_embeddings``); the rope variants and the CNN
encoder come later.  Inference only: the embedding dropout is a training
concern.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fluid_llm_tpu.config import EncoderConfig, PosEmbeddingConfig
from fluid_llm_tpu_torch.models.common import MLP


class PatchEncoder(nn.Module):
    """``patch_encoder.py:6-30``, MLP type: flat patch -> llm_dim."""

    def __init__(self, patch_in_dim: int, llm_dim: int, cfg: EncoderConfig):
        super().__init__()
        if cfg.type != "MLP":
            raise ValueError(f"patch encoder {cfg.type!r}: only MLP is ported")
        self.mlp = MLP(patch_in_dim, llm_dim, cfg.hidden_dim, cfg.num_layers, cfg.activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(bs, seq, N_patch, C, px, py) -> (bs, seq, N_patch, llm_dim)."""
        return self.mlp(x.flatten(3))


class PosEmbed(nn.Module):
    """Learned per-axis tables (``positional_embeddings.py:6-37``)."""

    def __init__(self, llm_dim: int, max_embeds: tuple[int, int, int], init_mode: str):
        super().__init__()
        self.x = nn.Parameter(torch.empty(max_embeds[0], llm_dim))
        self.y = nn.Parameter(torch.empty(max_embeds[1], llm_dim))
        self.t = nn.Parameter(torch.empty(max_embeds[2], llm_dim))
        self.init_mode = init_mode

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for table in (self.x, self.y, self.t):
            if self.init_mode == "zero":
                table.zero_()
            else:  # "normal": nn.Embedding's N(0, 1); "scaled": N(0, 1/d)
                std = 1.0 / math.sqrt(table.shape[1]) if self.init_mode == "scaled" else 1.0
                table.normal_(0.0, std, generator=generator)

    def forward(self, h: torch.Tensor, position_ids: torch.Tensor) -> torch.Tensor:
        """h: (..., llm_dim); position_ids: (..., 3) int -> h + ex + ey + et."""
        e = self.x[position_ids[..., 0]] + self.y[position_ids[..., 1]] + self.t[position_ids[..., 2]]
        return h + e.to(h.dtype)


class InputEmbeddings(nn.Module):
    """``input_embeddings.py:9-52``: patch encoder + positions (+ optional LN)."""

    def __init__(self, patch_in_dim: int, llm_dim: int, max_embeds: tuple[int, int, int],
                 enc_cfg: EncoderConfig, emb_cfg: PosEmbeddingConfig):
        super().__init__()
        if emb_cfg.pos_embedding_type != "pos":
            raise ValueError(f"pos_embedding_type {emb_cfg.pos_embedding_type!r}: only "
                             "'pos' is ported (rope comes with the streaming rollout)")
        self.patch = PatchEncoder(patch_in_dim, llm_dim, enc_cfg)
        self.pos = PosEmbed(llm_dim, max_embeds, emb_cfg.init_pos_embed)
        self.ln = nn.LayerNorm(llm_dim, eps=emb_cfg.in_emb_ln_eps) \
            if emb_cfg.in_emb_ln_eps is not None else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.patch.mlp.reset_parameters(generator)
        self.pos.reset_parameters(generator)
        if self.ln is not None:
            self.ln.reset_parameters()

    def forward(self, x: torch.Tensor, position_ids: torch.Tensor) -> torch.Tensor:
        """(bs, seq, N_patch, C, px, py) -> (bs, seq, N_patch, llm_dim)."""
        h = self.pos(self.patch(x), position_ids)
        if self.ln is not None:
            h = F.layer_norm(h, self.ln.normalized_shape, self.ln.weight, self.ln.bias, self.ln.eps)
        return h
