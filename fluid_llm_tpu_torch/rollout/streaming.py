"""Streaming rollout: encode each frame once against a KV cache.

Counterpart of ``fluid_llm_tpu/rollout/streaming.py``, as a Python loop.
The exact rollout (``rollout/generate.py``, like the reference,
``src/models/model.py:168-216``) re-encodes the whole window every step,
because its positions are window-relative.  This path serves
sliding-window LLM style instead, for models built for it:

- cache-stable input embeddings (``rope_abs``: static spatial scales,
  absolute time) and a rotary backbone (llama family), whose positions
  grow monotonically over the rollout;
- the BOS token and the see-init duplicate of the TRUE initial state are
  pinned attention sinks; the last ``max_ctx_len`` frames live in a ring of
  slabs (``backbone.init_streaming_cache``);
- each new frame runs through every block once (``backbone.
  apply_streaming``, attention ``ops/decode_attention.py``) and its K/V
  stay in the cache.

Equal to dense attention under a banded mask, not to the re-encoding
rollout; selected with ``inference.py --streaming``.  On a rank mesh
(``parallel/mesh.shard_model``) each rank streams its rows of the batch
with its share of the heads (the JAX ``test_streaming_sharded_matches_single``);
over pipeline stages each rank caches and runs its stage's blocks, the
hidden state passed stage to stage (``backbone.apply_streaming``).
"""

from __future__ import annotations

import copy

import torch

from fluid_llm_tpu_torch.models import backbone as bb
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.ops.patching import img_to_patch, patch_to_img
from fluid_llm_tpu_torch.tools.profiling import span


def _check_streaming_compat(model: FluidLLM) -> None:
    """The four configurations a cache cannot serve (``streaming.py:43-70``)."""
    if model.backbone_cfg.pos != "rope":
        raise ValueError(
            "streaming rollout needs a rotary-position backbone (llama family); "
            f"{model.cfg.llm_backbone!r} uses learned positions that are re-based per "
            "window and cannot be cached")
    if model.cfg.pos_embedding_params.pos_embedding_type != "rope_abs":
        raise ValueError(
            "streaming rollout needs cache-stable input embeddings: set "
            "pos_embedding_params.pos_embedding_type: rope_abs (the 'pos' table is "
            "window-re-zeroed and 'rope' normalises by batch max)")
    if model.cfg.decoder_params.type == "CNN":
        raise ValueError(
            "streaming rollout cannot serve the CNN patch decoder: its Conv1d spans the "
            "whole window's token stream, but streaming decodes one frame's tokens at a "
            "time; use the exact rollout")
    if not model.cfg.absolute_time_ids:
        raise ValueError(
            "streaming rollout needs absolute_time_ids: true -- a model trained on "
            "window-relative t would see the growing serving t far outside its "
            "training distribution")


def _sinks(model: FluidLLM, n_patch: int) -> int:
    cfg = model.cfg
    return (1 if cfg.use_bos_token else 0) + (n_patch if cfg.see_init_state else 0)


def streaming_cache(model: FluidLLM, init_states: torch.Tensor) -> dict:
    """The empty slab cache a rollout of ``init_states`` runs in, on their
    device (the daemon allocates it before the rollout's first collective)."""
    _check_streaming_compat(model)
    bs, init_len, n_patch = init_states.shape[:3]
    R = model.max_ctx_len  # ring capacity in frames
    if init_len > R:
        raise ValueError(f"streaming context ({init_len} frames) exceeds the ring capacity "
                         f"max_ctx_len={R}; pass at most {R} context states")
    par = model.backbone.parallel  # on a TP mesh the cache holds this rank's heads,
    cfg = model.backbone_cfg if par is None else par.cfg
    if par is not None and par.pipe is not None:  # on a pipeline stage its blocks'
        cfg = cfg.replace(n_layers=len(par.pipe.layers))
    return bb.init_streaming_cache(cfg, bs, _sinks(model, n_patch), R, n_patch,
                                   device=init_states.device)


@torch.inference_mode()
def generate_streaming(
    model: FluidLLM,
    init_states: torch.Tensor,
    bc_mask: torch.Tensor,
    position_ids: torch.Tensor,
    n_steps: int,
    cache: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ``rollout.generate.generate`` (patch tensors in/out).

    The model should be prepared (``prepare_inference_params``: adapters
    merged, qkv fused).  A model that still carries adapters is served
    from a prepared copy, leaving it as it was: ``apply_streaming`` uses
    plain linears, so unmerged adapters would otherwise be dropped.
    ``cache``: :func:`streaming_cache` of ``init_states``, allocated here
    if None.
    """
    if cache is None:
        cache = streaming_cache(model, init_states)
    if model.lora is not None:
        model = copy.deepcopy(model)
        model.prepare_inference_params()
    cfg, bcfg = model.cfg, model.backbone_cfg
    bs, init_len, n_patch = init_states.shape[:3]
    dev = init_states.device
    R = model.max_ctx_len
    n_sink = _sinks(model, n_patch)

    # static spatial ids; absolute time (t0 + frame * seq_interval) per frame
    spatial = position_ids[:, :1, :, :2]
    t0 = position_ids[:, 0, 0, 2]
    ival = cfg.seq_interval
    frame_tok = torch.arange(n_patch, dtype=torch.int32, device=dev)

    def embed_frame(state, f: int):
        tt = (t0 + f * ival)[:, None, None, None].expand(bs, 1, n_patch, 1)
        return model.embed_frames(state[:, None], torch.cat([spatial, tt], dim=-1))

    def token_base(f: int) -> int:  # absolute position of frame f's first token
        return n_sink + f * n_patch

    # ---- prefill: the sinks and every context frame but the last --------
    prefill = []
    if cfg.use_bos_token:
        prefill.append(model.bos.to(bcfg.dtype).expand(bs, 1, bcfg.embed_dim))
    if cfg.see_init_state:
        # the TRUE initial condition, pinned at t0 (the exact rollout
        # re-duplicates the window's first frame, which changes every step)
        prefill.append(embed_frame(init_states[:, 0], 0))
    prefill += [embed_frame(init_states[:, f], f) for f in range(init_len - 1)]
    if prefill:
        x0 = torch.cat(prefill, dim=1)
        p0 = torch.arange(x0.shape[1], dtype=torch.int32, device=dev)
        with span("fluid.backbone"):
            bb.apply_streaming(model.backbone, x0, p0, cache, 0, prefill=True,
                               frame_tokens=n_patch, kernels=model.kernels)

    # ---- decode: append one frame, read its diff -------------------------
    state = init_states[:, -1]
    next_states, all_diffs = [], []
    for i in range(n_steps):
        f = init_len - 1 + i  # the frame being appended
        x = embed_frame(state, f)
        with span("fluid.backbone"):
            y, cache = bb.apply_streaming(model.backbone, x, token_base(f) + frame_tok, cache,
                                          f % R, kernels=model.kernels)
        diffs = img_to_patch(model.decode_frame_tokens(y)[:, None], model.ds_props)[:, 0]
        # boundary forcing with the last available mask (``model.py:202,206``)
        diffs = torch.where(bc_mask[:, min(f, bc_mask.shape[1] - 1)], 0.0, diffs)
        state = state + diffs
        next_states.append(state)
        all_diffs.append(diffs)
    all_states = torch.cat([init_states, torch.stack(next_states, dim=1)], dim=1)
    return all_states, torch.stack(all_diffs, dim=1)


def gen_seq_streaming(
    model: FluidLLM, batch: tuple, pred_steps: int, start_state: int = 1
) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming counterpart of ``rollout.generate.gen_seq``: (states,
    diffs) as images."""
    states, _, _, bc_mask, position_ids = batch
    if pred_steps + start_state - 1 > states.shape[1]:
        raise ValueError(
            f"Prediction steps ({pred_steps}) + start state ({start_state}) "
            f"must be less than total sequence length {states.shape[1]}!"
        )
    all_states, all_diffs = generate_streaming(
        model, states[:, :start_state], bc_mask, position_ids, pred_steps
    )
    return patch_to_img(all_states, model.ds_props), patch_to_img(all_diffs, model.ds_props)
