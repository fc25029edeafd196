"""Autoregressive rollout over a fixed-shape, right-aligned window.

Counterpart of ``fluid_llm_tpu/rollout/generate.py`` (``generate``,
``gen_seq``), as a Python loop.  The reference generates with a deque of at
most ``max_ctx_len`` states, re-encoding the whole window every step
(``src/models/model.py:168-216``).  Semantics kept:

- the window buffer has ``W = max_ctx_len`` frame slots and is RIGHT-aligned:
  the newest frame always sits at ``W-1``, not-yet-filled slots occupy the
  front and are masked out of attention (cumsum positions in the backbone
  keep the learned-position indices equal to the dense computation);
- time position ids are re-zeroed per window (``model.py:196-199``): valid
  slot j carries ``t = j - start``, and see-init duplicates the first
  *valid* frame (``model.py:118-126``) with ``t = 0``; with
  ``absolute_time_ids`` (``generate.py:77-100``) every frame keeps its raw
  trajectory step instead, ``seq_interval`` steps apart from the window's
  base step;
- boundary-condition pixels are forced to zero diff with the mask of the
  last available state (``model.py:202,206``).

No KV cache, like the reference: the re-zeroed time ids change every
token's embedding as the window slides (``rollout/streaming.py`` serves
absolute-time rope models from a cache).

The rollout runs in inference mode unless ``grad`` is set: the ``notf``
training mode differentiates through it (``generate.py:36-60``), each step's
forward then rematerialised in the backward with ``remat``
(``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint`` of the
scan step).  Either way it draws no dropout, as the JAX rollout takes no
rng.  Given a ``moe_aux`` list (``notf`` over a MoE backbone, whose
gradient-bearing forward is the rollout) it appends the rollout's balance
loss: the mean over steps of each step's mean over blocks
(``generate.py:150-160``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.ops.patching import img_to_patch, patch_to_img
from fluid_llm_tpu_torch.tools.profiling import span


def generate(
    model: FluidLLM,
    init_states: torch.Tensor,
    bc_mask: torch.Tensor,
    position_ids: torch.Tensor,
    n_steps: int,
    *,
    grad: bool = False,
    remat: bool = False,
    moe_aux: Optional[list] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """init_states: (bs, init_len, N_patch, 3, px, py); bc_mask:
    (bs, seq, N_patch, 3, px, py) bool; position_ids: (bs, seq, N_patch, 3).
    ``grad``: keep the autograd graph (otherwise inference mode); ``remat``:
    recompute each step's forward in the backward, keeping only its input.
    ``moe_aux``: a list the rollout's MoE balance loss (a scalar) is
    appended to.

    Returns (all_states, all_diffs) as patch tensors of
    (bs, init_len + n_steps, ...) and (bs, n_steps, ...).
    """
    with span("fluid.rollout"):
        return _rollout(model, init_states, bc_mask, position_ids, n_steps, grad, remat, moe_aux)


def _rollout(model, init_states, bc_mask, position_ids, n_steps: int, grad: bool, remat: bool,
             moe_aux: Optional[list]):
    if not grad:
        if remat:
            raise ValueError("remat rematerialises a differentiated rollout: pass grad=True")
        with torch.inference_mode():
            return _generate(model, init_states, bc_mask, position_ids, n_steps, False, moe_aux)
    return _generate(model, init_states, bc_mask, position_ids, n_steps, remat, moe_aux)


def _generate(model, init_states, bc_mask, position_ids, n_steps: int, remat: bool,
              moe_aux: Optional[list] = None):
    bs, init_len, n_patch = init_states.shape[:3]
    W = model.max_ctx_len
    dev = init_states.device
    buffer = init_states.new_zeros((bs, W) + init_states.shape[2:])
    buffer[:, W - init_len:] = init_states
    spatial = position_ids[:, :1, :, :2].expand(bs, W, n_patch, 2)
    # the see-init duplicated frame always carries t=0
    dup_pos = torch.cat([spatial[:, 0], spatial.new_zeros(bs, n_patch, 1)], dim=-1)
    slot = torch.arange(W, device=dev)[None, :]
    abs_t, ival = model.cfg.absolute_time_ids, model.cfg.seq_interval
    t0 = position_ids[:, 0, 0, 2]  # the window's base step

    next_states, all_diffs, aux_steps = [], [], []
    for i in range(n_steps):
        with span("fluid.rollout_step"):  # its own ops: the window's glue
            start = W - min(init_len + i, W)  # first valid slot
            frame_valid = (slot >= start).expand(bs, W)
            if abs_t:
                # valid slot j holds raw step t0 + (init_len + i - W + j) * ival
                t_ids = (t0[:, None] + (init_len + i - W + slot) * ival).clamp_min(0)
                dup_t = t0 + max(init_len + i - W, 0) * ival
                dpos = torch.cat([spatial[:, 0], dup_t[:, None, None].expand(bs, n_patch, 1)],
                                 dim=-1)
            else:
                t_ids = (slot - start).clamp_min(0).expand(bs, W)
                dpos = dup_pos
            wpos = torch.cat([spatial, t_ids[:, :, None, None].expand(bs, W, n_patch, 1)], dim=-1)
            step_mask = bc_mask[:, min(init_len + i - 1, bc_mask.shape[1] - 1)]

            def step(buffer, wpos=wpos, frame_valid=frame_valid, dpos=dpos, start=start,
                     step_mask=step_mask):
                aux = [] if moe_aux is not None else None
                last_img = model.predict_frame_diff(
                    buffer, wpos, frame_valid, W - 1, init_frame=(buffer[:, start], dpos),
                    remat=False if remat else None,  # a rematerialised step keeps its blocks whole
                    moe_aux=aux,
                )
                diffs = img_to_patch(last_img[:, None], model.ds_props)[:, 0]
                diffs = torch.where(step_mask, 0.0, diffs)
                aux_step = sum(aux) / len(aux) if aux else None
                return buffer[:, W - 1] + diffs, diffs, aux_step

            next_state, diffs, aux_step = checkpoint(step, buffer, use_reentrant=False) if remat \
                else step(buffer)
            buffer = torch.cat([buffer[:, 1:], next_state[:, None]], dim=1)
            next_states.append(next_state)
            all_diffs.append(diffs)
            if aux_step is not None:
                aux_steps.append(aux_step)
    if aux_steps:
        moe_aux.append(torch.stack(aux_steps).mean())
    all_states = torch.cat([init_states, torch.stack(next_states, dim=1)], dim=1)
    return all_states, torch.stack(all_diffs, dim=1)


def gen_seq(
    model: FluidLLM, batch: tuple, pred_steps: int, start_state: int = 1, *,
    grad: bool = False, remat: bool = False, moe_aux: Optional[list] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``model.py:218-233``: generate from the first ``start_state`` states
    and return (states, diffs) as images; ``grad``/``remat``/``moe_aux`` as
    :func:`generate`."""
    states, _, _, bc_mask, position_ids = batch
    seq_len = states.shape[1]
    if pred_steps + start_state - 1 > seq_len:
        raise ValueError(
            f"Prediction steps ({pred_steps}) + start state ({start_state}) "
            f"must be less than total sequence length {seq_len}!"
        )
    with span("fluid.rollout"):
        all_states, all_diffs = _rollout(model, states[:, :start_state], bc_mask, position_ids,
                                         pred_steps, grad, remat, moe_aux)
        return patch_to_img(all_states, model.ds_props), patch_to_img(all_diffs, model.ds_props)
