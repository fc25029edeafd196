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

Unlike the JAX package the parameters live in the module, and which of
them train follows ``trainable_mask`` (``fluid_llm.py:170-182``): under
LoRA or ``freeze_llm`` the backbone is frozen (``requires_grad=False``, so
the optimizer holds no state for it); adapters, encoder, decoder and BOS
train.  The ported surface: ``forward`` (every frame decoded; in training
with dropout drawn from a ``torch.Generator``: embeddings, backbone,
adapters and the MLPGNN decoder's attention), ``forward_see_init`` and
``predict_diffs`` (the training forwards), the rollout's
``predict_frame_diff`` (the CNN decoder decodes the whole window; a MoE
backbone runs its final block whole), all with unmerged adapters and, with
``parallel.remat``, rematerialised backbone blocks; each takes ``moe_aux``,
a list the MoE blocks append their balance losses to.  Also
``prepare_inference_params`` (unstack -> merge adapters -> quantize, for
serving -> pack qkv -> cast -> stack, with ``FLUID_SCAN_LAYERS=1``),
``quantize_frozen`` (``llm_4bit_loading``: the frozen backbone as nf4),
and the streaming rollout's ``embed_frames`` and ``decode_frame_tokens``.

On a rank mesh (``parallel/mesh.shard_model``) the backbone runs its
share; ``forward`` with ``parallel.seq_sharded_acts`` runs its blocks on
this rank's chunk of the tokens (sequence parallelism, or ring attention
with ``parallel.ring_attention``: ``fluid_llm.py:271-305``), the rollout's
``predict_frame_diff`` on whole tokens, as the JAX package does.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

from fluid_llm_tpu_torch.config import Config, check_moe
from fluid_llm_tpu_torch.data.ds_props import DSProps
from fluid_llm_tpu_torch.models import backbone as bb
from fluid_llm_tpu_torch.models.decoders import PatchDecoder
from fluid_llm_tpu_torch.models.embeddings import InputEmbeddings
from fluid_llm_tpu_torch.models.lora import Lora, merge_lora
from fluid_llm_tpu_torch.ops.quant import quantize_backbone
from fluid_llm_tpu_torch.tools.profiling import span


class FluidLLM(nn.Module):
    """``kernels``: route the learned positions' add, the backbone's attention
    and the decoder's slot attention through the CUDA kernels on CUDA
    tensors (True), or through their plain PyTorch twins (False, for
    comparisons on the card)."""

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
        # ``trainable_mask``: the backbone trains only in full fine-tuning
        self.backbone.requires_grad_(not cfg.freeze_llm and not cfg.use_lora)

    @classmethod
    def build(cls, cfg: Config, ds_props: DSProps, *, kernels: bool = True,
              **backbone_overrides) -> "FluidLLM":
        """Model from the YAML config; ``half_precision`` picks a bf16 backbone,
        ``moe.experts > 0`` routed MLPs (the JAX guards, ``config.check_moe``).
        ``backbone_overrides`` replace fields of the backbone config (e.g.
        ``attn_impl="short"``, as the JAX package's ``FLUID_BENCH_ATTN``).
        With ``parallel.pipe_axis > 1`` (``parallel/pipeline.py``) the
        backbone trains full-FT: adapters raise, as the JAX ``init`` does
        (``fluid_llm.py:160-165``)."""
        check_moe(cfg.moe, cfg.parallel)
        if cfg.parallel.pipe_axis > 1 and cfg.use_lora and not cfg.freeze_llm:
            raise ValueError("pipeline parallelism requires full-FT (use_lora: false) -- "
                             "per-layer LoRA trees don't apply to the stacked layout")
        dtype = torch.bfloat16 if cfg.half_precision else torch.float32
        moe = dict(moe_experts=cfg.moe.experts, moe_top_k=cfg.moe.top_k,
                   moe_capacity_factor=cfg.moe.capacity_factor,
                   moe_router=cfg.moe.router) if cfg.moe.experts > 0 else {}
        bcfg = bb.preset(cfg.llm_backbone, cfg.llm_layers).replace(
            dtype=dtype, flash_attention=cfg.flash_attention, remat=cfg.parallel.remat, **moe)
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
    def quantize_frozen(self) -> bool:
        """With ``llm_4bit_loading`` and a frozen backbone (adapters or
        ``freeze_llm``), store the backbone as packed nf4 in place
        (``ops/quant.quantize_backbone``; expert banks and shapes nf4 cannot
        pack as int8), as ``fluid_llm_tpu/main.py:101-110`` does after the
        weights are drawn: DoRA's ``m`` comes from the float weight.  Also
        the template a checkpoint of such a run restores into.  Returns
        whether it quantized."""
        cfg = self.cfg
        if not (cfg.llm_4bit_loading and (cfg.use_lora or cfg.freeze_llm)):
            return False
        quantize_backbone(self.backbone, "nf4")
        return True

    @torch.no_grad()
    def prepare_inference_params(self, quant: Optional[str] = None, qmm_mode: str = "w8a16",
                                 stack_layers: bool = False) -> None:
        """Inference-time transform, in place (``fluid_llm.py:114-135``): the
        layer list back if it is stacked (``backbone.unstack_layers``); fold
        the LoRA/DoRA adapters into the backbone (``lora.merge_lora``) and
        drop them; with ``quant`` ("int8" | "nf4") store the backbone's
        linears quantized (``ops/quant.quantize_backbone``, int8 ones applied
        in ``qmm_mode``); fuse each layer's float q/k/v
        (``backbone.pack_qkv_params``) and store the float matmul weights in
        the activation dtype (``backbone.cast_matmul_params``); last, with
        ``stack_layers`` or ``FLUID_SCAN_LAYERS=1`` in the environment, the
        stacked layout (``backbone.stack_layers``).  The order of
        ``tools/serve.py:442-457``; exact without ``quant``.  On a rank mesh
        (``parallel/mesh.shard_model``) the adapters merge into this rank's
        part, each linear is quantized from its whole weight and cut again
        (merge, quantize, cut, as ``fluid_llm_tpu/tools/serve.py:442-456``;
        ``ops/quant._stored``), and the stacked layout of a tensor-parallel
        backbone is refused, as the JAX entry points never stack on a mesh."""
        bb.unstack_layers(self.backbone)
        if self.lora is not None:
            merge_lora(self.backbone, self.lora)
            self.lora = None
        if quant is not None:
            quantize_backbone(self.backbone, quant, qmm_mode)
        bb.pack_qkv_params(self.backbone)
        bb.cast_matmul_params(self.backbone, self.backbone_cfg.dtype)
        if stack_layers or os.environ.get("FLUID_SCAN_LAYERS", "0") == "1":
            bb.stack_layers(self.backbone)

    def _embed(self, states, position_ids, frame_valid, generator=None):
        """Embeddings (f32) -> backbone dtype, flattened, BOS prepended;
        ``frame_valid`` None: every frame valid."""
        with span("fluid.encoder"):
            bs, seq_len, n_patch = states.shape[:3]
            if frame_valid is None:
                frame_valid = torch.ones(bs, seq_len, dtype=torch.bool, device=states.device)
            h = self._frames(states, position_ids, generator)
            token_valid = frame_valid.repeat_interleave(n_patch, dim=1)
            if self.bos is not None:
                bos = self.bos.to(h.dtype).expand(bs, 1, h.shape[-1])
                h = torch.cat([bos, h], dim=1)
                ones = torch.ones(bs, 1, dtype=torch.bool, device=h.device)
                token_valid = torch.cat([ones, token_valid], dim=1)
            return h, token_valid

    def _frames(self, states, position_ids, generator=None) -> torch.Tensor:
        bs, f, n = states.shape[:3]
        h = self.input_emb(states, position_ids, generator,
                           spatial_scale=(self.ds_props.Nx_patch, self.ds_props.Ny_patch),
                           kernels=self.kernels)
        return h.to(self.backbone_cfg.dtype).reshape(bs, f * n, -1)

    def embed_frames(self, states, position_ids, generator=None) -> torch.Tensor:
        """Input embeddings of whole frames (``fluid_llm.py:363-376``):
        states (bs, f, N_patch, C, px, py), position_ids (bs, f, N_patch, 3)
        -> (bs, f*N_patch, d) in the backbone dtype.  ``rope_abs`` reads the
        static patch-grid extent (``fluid_llm.py:227-231``).  The streaming
        rollout encodes each new frame once with it."""
        with span("fluid.encoder"):
            return self._frames(states, position_ids, generator)

    def decode_frame_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Backbone output tokens of one frame (bs, N_patch, d) -> diff
        image (bs, 3, X, Y), f32, scaled (``fluid_llm.py:378-385``)."""
        with span("fluid.decoder"):
            preds = self.decoder(tokens[:, None], self.kernels)
            return preds[:, 0].permute(0, 3, 1, 2).float() * self.cfg.diff_scale_factor

    def forward(self, x: torch.Tensor, position_ids: torch.Tensor, *,
                frame_valid: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                moe_aux: Optional[list] = None) -> torch.Tensor:
        """``model.py:128-152``: every frame decoded.

        x: (bs, seq, N_patch, 3, px, py); position_ids: (bs, seq, N_patch, 3);
        frame_valid: optional (bs, seq) bool.  ``train``: dropout (input
        embeddings, backbone stream and residuals, adapter inputs) drawn from
        ``generator``, which it then needs.  ``moe_aux``: a list the MoE
        blocks append their balance losses to.  Returns diffs as images
        (bs, seq, 3, tot_px, tot_py), f32.
        """
        if train and generator is None:
            raise ValueError("training forward needs a generator for its dropout")
        par = self.cfg.parallel
        if par.ring_attention and not (par.seq_sharded_acts and par.model_axis > 1):
            raise ValueError("parallel.ring_attention needs tokens sharded over the model axis "
                             "-- set seq_sharded_acts: true and model_axis > 1")
        gen = generator if train else None
        bs, seq_len, n_patch = x.shape[:3]
        h, token_valid = self._embed(x, position_ids, frame_valid, gen)
        with span("fluid.backbone"):
            out = self.backbone(h, token_valid, kernels=self.kernels, lora=self.lora,
                                generator=gen, moe_aux=moe_aux, seq_shard=par.seq_sharded_acts)
        with span("fluid.decoder"):  # the tokens into frames: a copy, past the BOS
            if self.bos is not None:
                out = out[:, 1:]
            preds = self.decoder(out.reshape(bs, seq_len, n_patch, -1), self.kernels, gen)
            return preds.permute(0, 1, 4, 2, 3).float() * self.cfg.diff_scale_factor

    def forward_see_init(self, states: torch.Tensor, position_ids: torch.Tensor,
                         **kw) -> torch.Tensor:
        """Duplicate the first frame, run ``forward``, drop its prediction
        (``model.py:118-126``)."""
        with span("fluid.encoder"):  # the duplicated frame is the encoder's input
            states = torch.cat([states[:, :1], states], dim=1)
            position_ids = torch.cat([position_ids[:, :1], position_ids], dim=1)
            fv = kw.get("frame_valid")
            if fv is not None:
                kw["frame_valid"] = torch.cat([fv[:, :1], fv], dim=1)
        return self.forward(states, position_ids, **kw)[:, 1:]

    def predict_diffs(self, states: torch.Tensor, position_ids: torch.Tensor,
                      **kw) -> torch.Tensor:
        """Dispatch on ``see_init_state`` (``trainer.py:89-92``)."""
        if self.cfg.see_init_state:
            return self.forward_see_init(states, position_ids, **kw)
        return self.forward(states, position_ids, **kw)

    def predict_frame_diff(
        self,
        states: torch.Tensor,
        position_ids: torch.Tensor,
        frame_valid: torch.Tensor,
        frame_idx: int,
        init_frame: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
        remat: Optional[bool] = None,
        moe_aux: Optional[list] = None,
    ) -> torch.Tensor:
        """Rollout hot path: full-window backbone, single-frame decode.

        The reference re-encodes the window, decodes every frame and keeps
        the last (``model.py:161-166``); the decoder acts per frame, so
        decoding only ``frame_idx`` is exact.  ``init_frame``: optional
        (state, position_ids) used as the see-init duplicated frame instead
        of ``states[:, 0]`` (the right-aligned rollout window's first valid
        frame).  ``remat``: the backbone's (None: the config's).
        ``moe_aux``: as :meth:`forward`'s.  Returns the diff image of window
        frame ``frame_idx``: (bs, 3, X, Y), f32.

        The CNN decoder's Conv1d spans the whole window's token stream, so
        it decodes every frame of a full-window backbone and keeps
        ``frame_idx``'s (``fluid_llm.py:465-499``), with the tokens of
        invalid frames zeroed first.  A MoE backbone runs its final block
        over the whole window too, then keeps the frame's tokens: expert
        capacity couples the tokens of a layer, so the slice would route
        differently (``fluid_llm.py:542-551``).
        """
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

        def run(**kw):
            with span("fluid.backbone"):
                return self.backbone(h, token_valid, kernels=self.kernels, lora=self.lora,
                                     remat=remat, moe_aux=moe_aux, **kw)

        if self.cfg.decoder_params.type == "CNN":
            out = run()
            with span("fluid.decoder"):
                if self.bos is not None:
                    out = out[:, 1:]
                valid_tok = frame_valid.repeat_interleave(n_patch, dim=1)[..., None]
                out = torch.where(valid_tok, out,
                                  torch.zeros((), dtype=out.dtype, device=out.device))
                preds = self.decoder(out.reshape(bs, -1, n_patch, out.shape[-1]), self.kernels)
                return preds[:, out_idx].permute(0, 3, 1, 2).float() * \
                    self.cfg.diff_scale_factor
        tok_start = out_idx * n_patch + (1 if self.bos is not None else 0)
        if self.backbone_cfg.moe_experts > 0:
            out = run()[:, tok_start:tok_start + n_patch]
        else:
            out = run(decode_slice=(tok_start, n_patch))
        return self.decode_frame_tokens(out)
