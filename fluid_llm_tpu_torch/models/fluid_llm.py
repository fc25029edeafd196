"""FluidLLM: patches -> LLM backbone -> per-pixel diff predictions.

Counterpart of ``fluid_llm_tpu/models/fluid_llm.py`` (``MultivariateTimeLLM``,
``src/models/model.py:26``):

- patch embeddings + 3-axis positions (``model.py:84-89``), computed in f32
  and cast to the backbone dtype (``fluid_llm.py:435``);
- flatten (bs, seq, N_patch, d) -> (bs, seq*N_patch, d) (``model.py:138``);
- optional trainable BOS embedding prepended (``model.py:62-73,139-142``);
- the causal backbone on ``inputs_embeds``;
- the patch decoder to per-pixel (Vx, Vy, P) diffs, cast to f32 and scaled
  by ``diff_scale_factor`` (``model.py:148-152``, ``fluid_llm.py:517-518``).

Unlike the JAX package the parameters live in the module.  The ported
surface is inference: ``forward`` (every frame decoded), the rollout's
``predict_frame_diff`` (non-CNN, non-MoE branch) and
``prepare_inference_params`` (merge adapters -> pack qkv -> cast).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fluid_llm_tpu.config import Config
from fluid_llm_tpu_torch.data.ds_props import DSProps
from fluid_llm_tpu_torch.models import backbone as bb
from fluid_llm_tpu_torch.models.decoders import PatchDecoder
from fluid_llm_tpu_torch.models.embeddings import InputEmbeddings
from fluid_llm_tpu_torch.models.lora import Lora, merge_lora


class FluidLLM(nn.Module):
    """``kernels``: route the backbone's attention and the decoder's slot
    attention through the CUDA kernels on CUDA tensors (True), or through
    their plain PyTorch twins (False, for comparisons on the card)."""

    def __init__(self, cfg: Config, ds_props: DSProps, backbone_cfg: bb.BackboneConfig,
                 kernels: bool = True):
        super().__init__()
        self.cfg, self.ds_props, self.backbone_cfg = cfg, ds_props, backbone_cfg
        self.kernels = kernels
        # encoder/decoder/BOS live at the backbone's embedding width
        d = backbone_cfg.embed_dim
        self.backbone = bb.Backbone(backbone_cfg)
        self.input_emb = InputEmbeddings(
            ds_props.patch_in_dim, d,
            (ds_props.Nx_patch, ds_props.Ny_patch, self.max_seq_len),
            cfg.encoder_params, cfg.pos_embedding_params,
        )
        self.decoder = PatchDecoder(d, ds_props, cfg.decoder_params)
        self.bos = nn.Parameter(torch.empty(d)) if cfg.use_bos_token else None
        self.lora = Lora(self.backbone, cfg.lora_config) \
            if cfg.use_lora and not cfg.freeze_llm else None

    @classmethod
    def build(cls, cfg: Config, ds_props: DSProps, *, kernels: bool = True,
              **backbone_overrides) -> "FluidLLM":
        """Model from the YAML config; ``half_precision`` picks a bf16 backbone."""
        if cfg.moe.experts > 0 or cfg.parallel.pipe_axis > 1:
            raise ValueError("MoE and pipeline-parallel backbones are not ported yet")
        dtype = torch.bfloat16 if cfg.half_precision else torch.float32
        bcfg = bb.preset(cfg.llm_backbone, cfg.llm_layers).replace(dtype=dtype)
        if backbone_overrides:
            bcfg = bcfg.replace(**backbone_overrides)
        return cls(cfg, ds_props, bcfg, kernels=kernels)

    # ``max_seq_len``: +1 input frame when see_init duplicates frame 0
    # (``model.py:79``); the positional t-table must cover it.
    @property
    def max_seq_len(self) -> int:
        return self.ds_props.seq_len + 1 if self.cfg.see_init_state else self.ds_props.seq_len

    @property
    def max_ctx_len(self) -> int:
        return self.max_seq_len  # ``model.py:94``

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights with the JAX package's init distributions, drawn
        from ``generator`` (call on CPU parameters, then move the module)."""
        self.backbone.reset_parameters(generator)
        self.input_emb.reset_parameters(generator)
        self.decoder.reset_parameters(generator)
        if self.bos is not None:
            self.bos.normal_(0.0, 0.02, generator=generator)
        if self.lora is not None:
            self.lora.reset_parameters(self.backbone, generator)

    @torch.no_grad()
    def prepare_inference_params(self) -> None:
        """Exact inference-time transform, in place: fold the LoRA/DoRA
        adapters into the backbone (``lora.merge_lora``), fuse each layer's
        q/k/v (``backbone.pack_qkv_params``) and store the matmul weights in
        the activation dtype (``backbone.cast_matmul_params``)."""
        if self.lora is not None:
            merge_lora(self.backbone, self.lora)
            self.lora = None
        bb.pack_qkv_params(self.backbone)
        bb.cast_matmul_params(self.backbone, self.backbone_cfg.dtype)

    def _embed(self, states, position_ids, frame_valid):
        """Embeddings (f32) -> backbone dtype, flattened, BOS prepended."""
        bs, seq_len, n_patch = states.shape[:3]
        h = self.input_emb(states, position_ids)
        h = h.to(self.backbone_cfg.dtype).reshape(bs, seq_len * n_patch, -1)
        token_valid = frame_valid.repeat_interleave(n_patch, dim=1)
        if self.bos is not None:
            bos = self.bos.to(h.dtype).expand(bs, 1, h.shape[-1])
            h = torch.cat([bos, h], dim=1)
            ones = torch.ones(bs, 1, dtype=torch.bool, device=h.device)
            token_valid = torch.cat([ones, token_valid], dim=1)
        return h, token_valid

    def _check_merged(self) -> None:
        if self.lora is not None:
            raise RuntimeError("unmerged adapters: call prepare_inference_params() first "
                               "(the unmerged LoRA forward comes with training)")

    def forward(self, x: torch.Tensor, position_ids: torch.Tensor, *,
                frame_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``model.py:128-152``: every frame decoded.

        x: (bs, seq, N_patch, 3, px, py); position_ids: (bs, seq, N_patch, 3);
        frame_valid: optional (bs, seq) bool.  Returns diffs as images
        (bs, seq, 3, tot_px, tot_py), f32.
        """
        self._check_merged()
        bs, seq_len, n_patch = x.shape[:3]
        if frame_valid is None:
            frame_valid = torch.ones(bs, seq_len, dtype=torch.bool, device=x.device)
        h, token_valid = self._embed(x, position_ids, frame_valid)
        out = self.backbone(h, token_valid, kernels=self.kernels)
        if self.bos is not None:
            out = out[:, 1:]
        preds = self.decoder(out.reshape(bs, seq_len, n_patch, -1), self.kernels)
        return preds.permute(0, 1, 4, 2, 3).float() * self.cfg.diff_scale_factor

    def predict_frame_diff(
        self,
        states: torch.Tensor,
        position_ids: torch.Tensor,
        frame_valid: torch.Tensor,
        frame_idx: int,
        init_frame: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Rollout hot path: full-window backbone, single-frame decode.

        The reference re-encodes the window, decodes every frame and keeps
        the last (``model.py:161-166``); the decoder acts per frame, so
        decoding only ``frame_idx`` is exact.  ``init_frame``: optional
        (state, position_ids) used as the see-init duplicated frame instead
        of ``states[:, 0]`` (the right-aligned rollout window's first valid
        frame).  Returns the diff image of window frame ``frame_idx``:
        (bs, 3, X, Y), f32.
        """
        self._check_merged()
        bs, seq_len, n_patch = states.shape[:3]
        out_idx = frame_idx
        if self.cfg.see_init_state:
            dup_s, dup_p = init_frame if init_frame is not None \
                else (states[:, 0], position_ids[:, 0])
            states = torch.cat([dup_s[:, None], states], dim=1)
            position_ids = torch.cat([dup_p[:, None], position_ids], dim=1)
            ones = torch.ones(bs, 1, dtype=torch.bool, device=states.device)
            frame_valid = torch.cat([ones, frame_valid], dim=1)
            out_idx = frame_idx + 1  # drop the duplicated frame's prediction
        h, token_valid = self._embed(states, position_ids, frame_valid)
        tok_start = out_idx * n_patch + (1 if self.bos is not None else 0)
        out = self.backbone(h, token_valid, decode_slice=(tok_start, n_patch),
                            kernels=self.kernels)
        preds = self.decoder(out[:, None], self.kernels)
        return preds[:, 0].permute(0, 3, 1, 2).float() * self.cfg.diff_scale_factor
