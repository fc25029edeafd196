"""Training and validation steps.

Counterpart of ``fluid_llm_tpu/train/trainer.py:93-242`` (``src/trainer.py``):

- ``autoreg`` (``run_train_step``): teacher-forced one-step diffs, with
  optional input noise scaled by the per-sample diff std;
- ``gen`` (``run_gen_train_step``): a no-grad rollout makes guide states,
  the model is trained on single-step corrections from them (the JAX
  package's correction of the reference's off-by-one guide kept);
- ``val_step`` (``run_val_step``): a no-grad rollout over the validation
  sequence, losses and N-RMSE.

``notf`` differentiates through the exact rollout, whose attention kernel
has no backward yet; it raises.  Dropout and noise draw from one
``torch.Generator`` on the model's device, seeded from ``cfg.seed``.
"""

from __future__ import annotations

from typing import Optional

import torch

from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.ops.patching import img_to_patch, patch_to_img
from fluid_llm_tpu_torch.rollout.generate import gen_seq
from fluid_llm_tpu_torch.train.losses import combined_loss
from fluid_llm_tpu_torch.train.metrics import calc_n_rmse, normalise_states
from fluid_llm_tpu_torch.train.optim import build_optimizer


class Trainer:
    def __init__(self, model: FluidLLM, generator: Optional[torch.Generator] = None):
        self.model = model
        self.cfg = model.cfg
        self.opt = build_optimizer(self.cfg, (p for p in model.parameters() if p.requires_grad))
        device = next(model.parameters()).device
        self.generator = generator if generator is not None else \
            torch.Generator(device=device).manual_seed(self.cfg.seed)

    def mode_loss(self, batch: tuple, mode: str) -> tuple[torch.Tensor, dict]:
        """Loss and metrics of one batch (``trainer.py:121-199``)."""
        cfg, model, gen = self.cfg, self.model, self.generator
        states, next_state, diffs, bc_mask, position_ids = batch
        if mode == "autoreg":
            input_states = states
            if cfg.noise is not None:
                std = diffs.std(dim=(-1, -2, -3, -4, -5), keepdim=True)
                noise = torch.randn(states.shape, generator=gen, device=states.device,
                                    dtype=states.dtype)
                input_states = states + noise * (~bc_mask).to(states.dtype) * std * cfg.noise
            pred_diff = model.predict_diffs(input_states, position_ids, train=True, generator=gen)
            pred_state = patch_to_img(input_states, model.ds_props) + pred_diff
        elif mode == "gen":
            guide_img, _ = gen_seq(model, batch, states.shape[1] - 1)
            guide_img = guide_img.clone()  # out of inference mode, into autograd
            pred_diffs = model.forward_see_init(img_to_patch(guide_img, model.ds_props),
                                                position_ids, train=True, generator=gen)
            pred_state = guide_img + pred_diffs
        elif mode == "notf":
            raise NotImplementedError("notf training differentiates through the exact rollout, "
                                      "whose attention kernel has no backward yet")
        else:
            raise ValueError(mode)

        next_img = patch_to_img(next_state, model.ds_props)
        mask_img = patch_to_img(bc_mask.float(), model.ds_props).bool()
        preds, target = pred_state, next_img
        if cfg.loss_norm_eps is not None:
            target, preds = normalise_states(diffs, next_img, pred_state, cfg.loss_norm_eps,
                                             cfg.channel_independent)
        loss, metrics = combined_loss(preds, target, mask_img, cfg.loss_function,
                                      cfg.loss_weighting, cfg.pressure_weight)
        metrics["loss"] = loss
        metrics["N_RMSE"] = calc_n_rmse(pred_state.detach(), next_img, mask_img)
        return loss, metrics

    def train_step(self, batch: tuple, mode: str = "autoreg") -> dict:
        """One optimizer step; returns the metrics, detached, on the device."""
        self.opt.zero_grad(set_to_none=True)
        loss, metrics = self.mode_loss(batch, mode)
        loss.backward()
        self.opt.step()
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def val_step(self, batch: tuple) -> dict:
        """``run_val_step`` (``trainer.py:213-231``): rollout over the whole
        sequence from its first state."""
        model, cfg = self.model, self.cfg
        states, _, _, bc_mask, _ = batch
        pred_states, _ = gen_seq(model, batch, states.shape[1])
        pred_states = pred_states[:, :-1]
        states_img = patch_to_img(states, model.ds_props)
        mask_img = patch_to_img(bc_mask.float(), model.ds_props).bool()
        loss, metrics = combined_loss(pred_states, states_img, mask_img, cfg.loss_function,
                                      cfg.loss_weighting, cfg.pressure_weight)
        metrics["loss"] = loss
        metrics["N_RMSE"] = calc_n_rmse(pred_states, states_img, mask_img)
        return metrics
