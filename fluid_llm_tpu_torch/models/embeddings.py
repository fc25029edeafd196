"""Input embedding stack: MLP or CNN patch encoder + 3-axis positions.

Counterpart of ``fluid_llm_tpu/models/embeddings.py`` (``patch_encoder``
:28-45, ``pos_embed`` :48-66, the additive sin/cos ladders
``rotary3d_apply`` and ``rotary3d_abs_apply`` :72-136,
``input_embeddings``).  In training, ``input_emb_layer_dropout`` acts on
the result, drawn from a ``torch.Generator`` (``embeddings.py:185-189``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fluid_llm_tpu_torch.config import EncoderConfig, PosEmbeddingConfig
from fluid_llm_tpu_torch.models.common import CNN, MLP, dropout


class PatchEncoder(nn.Module):
    """``patch_encoder.py:6-30``: ``MLP`` (flat patch -> llm_dim) or ``CNN``
    (3x3 convs over each patch's 3 channels, then the mean over its pixels,
    ``patch_encoder.py:17-19``)."""

    def __init__(self, patch_in_dim: int, llm_dim: int, cfg: EncoderConfig):
        super().__init__()
        self.mlp = self.cnn = None
        if cfg.type == "MLP":
            self.mlp = MLP(patch_in_dim, llm_dim, cfg.hidden_dim, cfg.num_layers, cfg.activation)
        elif cfg.type == "CNN":
            self.cnn = CNN(3, llm_dim, cfg.hidden_dim, cfg.num_layers, cfg.activation)
        else:
            raise ValueError(f"Unknown patch embedding type: {cfg.type}")

    def reset_parameters(self, generator: torch.Generator) -> None:
        (self.mlp if self.mlp is not None else self.cnn).reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(bs, seq, N_patch, C, px, py) -> (bs, seq, N_patch, llm_dim)."""
        if self.mlp is not None:
            return self.mlp(x.flatten(3))
        bs, seq, n = x.shape[:3]
        out = self.cnn(x.reshape(bs * seq * n, *x.shape[3:]))
        return out.mean(dim=(-2, -1)).reshape(bs, seq, n, -1)


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


def _sincos_ladder3(x: torch.Tensor, pos_scaled: torch.Tensor) -> torch.Tensor:
    """Add the reference's 3-axis sinusoid ladder to ``x`` (bs, seq, N, d).

    pos_scaled: (bs, L, 3) f32 pre-scaled positions (the two callers differ
    only in the scaling).  Per axis i the sin/cos pair is written blockwise
    into the i-th third of the features and truncated to ``d // 3``, so only
    the sines survive (``rotary_3d_positional_embeddings.py:29-48``).
    ``dim_t`` runs over the full width ``d``.
    """
    bs, seq, n, d = x.shape
    L = seq * n
    third = d // 3
    dim_t = torch.pow(10000.0, 2.0 * torch.arange(third, dtype=torch.float32,
                                                  device=x.device) / d)
    pe = torch.zeros(bs, L, d, dtype=torch.float32, device=x.device)
    for i in range(3):
        pos_i = pos_scaled[:, :, i, None] / dim_t  # (bs, L, third)
        pe_i = torch.stack([torch.sin(pos_i), torch.cos(pos_i)], dim=2).reshape(bs, L, -1)
        pe[:, :, i * third:(i + 1) * third] = pe_i[:, :, :third]
    return x + pe.reshape(bs, seq, n, d).to(x.dtype)


def rotary3d_apply(x: torch.Tensor, position_ids: torch.Tensor) -> torch.Tensor:
    """``rope``: each axis normalised by its batch maximum, times 2 pi
    (``rotary_3d_positional_embeddings.py:6-61``).  x: (bs, seq, N, d);
    position_ids: (bs, seq, N, 3)."""
    bs, seq, n, _ = x.shape
    pos = position_ids.reshape(bs, seq * n, 3).float()
    max_vals = pos.amax(dim=1, keepdim=True)
    safe_max = torch.where(max_vals > 0, max_vals, torch.ones_like(max_vals))
    return _sincos_ladder3(x, pos / safe_max * (2 * math.pi))


def rotary3d_abs_apply(x: torch.Tensor, position_ids: torch.Tensor,
                       spatial_scale: tuple[int, int]) -> torch.Tensor:
    """``rope_abs``, the cache-stable variant for streaming serving: the
    spatial axes are normalised by the static patch-grid extent
    ``spatial_scale`` = (Nx_patch, Ny_patch) (times 2 pi), time enters raw,
    so a token's embedding depends on its absolute (x, y, t) alone."""
    bs, seq, n, _ = x.shape
    pos = position_ids.reshape(bs, seq * n, 3).float()
    sx, sy = spatial_scale
    mult = torch.tensor([2 * math.pi / max(sx - 1, 1), 2 * math.pi / max(sy - 1, 1), 1.0],
                        dtype=torch.float32, device=x.device)
    return _sincos_ladder3(x, pos * mult)


class InputEmbeddings(nn.Module):
    """``input_embeddings.py:9-52``: patch encoder + positions (+ optional LN).

    Positions by ``pos_embedding_type``: ``pos`` (learned tables), ``rope``
    or ``rope_abs`` (sin/cos ladders, no parameters)."""

    def __init__(self, patch_in_dim: int, llm_dim: int, max_embeds: tuple[int, int, int],
                 enc_cfg: EncoderConfig, emb_cfg: PosEmbeddingConfig):
        super().__init__()
        self.patch = PatchEncoder(patch_in_dim, llm_dim, enc_cfg)
        self.pos_type = emb_cfg.pos_embedding_type
        self.pos = PosEmbed(llm_dim, max_embeds, emb_cfg.init_pos_embed) \
            if self.pos_type == "pos" else None
        self.ln = nn.LayerNorm(llm_dim, eps=emb_cfg.in_emb_ln_eps) \
            if emb_cfg.in_emb_ln_eps is not None else None
        self.dropout = emb_cfg.input_emb_layer_dropout or 0.0

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.patch.reset_parameters(generator)
        if self.pos is not None:
            self.pos.reset_parameters(generator)
        if self.ln is not None:
            self.ln.reset_parameters()

    def forward(self, x: torch.Tensor, position_ids: torch.Tensor,
                generator: torch.Generator | None = None,
                spatial_scale: tuple[int, int] | None = None) -> torch.Tensor:
        """(bs, seq, N_patch, C, px, py) -> (bs, seq, N_patch, llm_dim);
        ``generator``: training, with the layer's dropout drawn from it;
        ``spatial_scale``: (Nx_patch, Ny_patch), which ``rope_abs`` needs."""
        h = self.patch(x)
        if self.pos_type == "pos":
            h = self.pos(h, position_ids)
        elif self.pos_type == "rope_abs":
            if spatial_scale is None:
                raise ValueError("rope_abs needs the static spatial_scale (Nx, Ny)")
            h = rotary3d_abs_apply(h, position_ids, spatial_scale)
        else:
            h = rotary3d_apply(h, position_ids)
        if self.ln is not None:
            h = F.layer_norm(h, self.ln.normalized_shape, self.ln.weight, self.ln.bias, self.ln.eps)
        if generator is not None:
            h = dropout(h, self.dropout, generator)
        return h
