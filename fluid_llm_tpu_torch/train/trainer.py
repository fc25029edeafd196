"""Training and validation steps.

Counterpart of ``fluid_llm_tpu/train/trainer.py:93-242`` (``src/trainer.py``):

- ``autoreg`` (``run_train_step``): teacher-forced one-step diffs, with
  optional input noise scaled by the per-sample diff std;
- ``gen`` (``run_gen_train_step``): a no-grad rollout makes guide states,
  the model is trained on single-step corrections from them (the JAX
  package's correction of the reference's off-by-one guide kept);
- ``notf`` (``run_notf_train_step``): the loss through the whole rollout
  from the first state, differentiated end to end (``trainer.py:158-168``;
  the JAX package's correction of the reference's one-step-short rollout
  kept): every step's window attention through the flash Function, its
  decoder through ``SlotAttention``; each step rematerialised with
  ``parallel.remat``.  The rollout draws no dropout, as the JAX one;
- ``val_step`` (``run_val_step``): a no-grad rollout over the validation
  sequence, losses and N-RMSE.

Dropout and noise draw from one ``torch.Generator`` on the model's device,
seeded from ``cfg.seed``.

A MoE backbone adds ``moe.aux_weight`` times the mean of its blocks'
balance losses to the loss and logs it as ``moe_aux`` (``trainer.py:
129-192``): ``autoreg`` and ``gen`` from their gradient-bearing forward
(``gen``'s guide rollout collects none), ``notf`` from its rollout.  With
``frozen_bf16`` the frozen backbone is stored in bf16
(:func:`cast_frozen_bf16`).

On a rank mesh (``model.mesh``, ``parallel/mesh.shard_model``) a step
takes this rank's rows of the global batch; its losses reduce over the
global batch (``comm.batch_axes``), its dropout and noise are one
process's draws cut to those rows (``models.common.draw_shards``), and
the gradients are summed over the ranks that hold parts of them before the
optimizer steps (``parallel.mesh.sync_grads``).  The metrics come back
global on every rank (N-RMSE's rows gathered).
"""

from __future__ import annotations

from contextlib import ExitStack, nullcontext
from typing import Optional

import torch

from fluid_llm_tpu_torch.models.common import draw, draw_shards
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.parallel import comm
from fluid_llm_tpu_torch.parallel.mesh import sync_grads
from fluid_llm_tpu_torch.ops.patching import img_to_patch, patch_to_img
from fluid_llm_tpu_torch.rollout.generate import gen_seq
from fluid_llm_tpu_torch.tools.profiling import span
from fluid_llm_tpu_torch.train.losses import combined_loss
from fluid_llm_tpu_torch.train.metrics import calc_n_rmse, normalise_states
from fluid_llm_tpu_torch.train.optim import build_optimizer


@torch.no_grad()
def cast_frozen_bf16(model: FluidLLM) -> None:
    """Store the frozen backbone's f32 parameters in bf16, in place
    (``cfg.frozen_bf16``, ``trainer.py:44-60``; the reference loads its
    backbone in bf16 and trains f32 adapters over it).  Trainable
    parameters and every module outside the backbone keep their dtype.
    Quantized storage (``QuantLinear``, ``NF4Linear``: the int8/uint8 bytes,
    their f32 scale chains and f32 bias) is buffers, not parameters, so it
    is skipped whole: its scales carry the dynamic range.  The JAX walk
    recognises int8 storage by its ``q`` leaf and so casts an nf4 absmax
    chain and a quantized linear's bias; the port keeps both f32, as that
    function's docstring intends (the int8 kernel also takes its bias in
    f32).  A storage change only: every forward casts weights to the
    activation dtype at use."""
    for p in model.backbone.parameters():
        if not p.requires_grad and p.dtype == torch.float32:
            p.data = p.data.to(torch.bfloat16)


class Trainer:
    def __init__(self, model: FluidLLM, generator: Optional[torch.Generator] = None):
        self.model = model
        self.cfg = model.cfg
        if self.cfg.frozen_bf16:
            cast_frozen_bf16(model)
        self.opt = build_optimizer(self.cfg, (p for p in model.parameters() if p.requires_grad))
        device = next(model.parameters()).device
        self.generator = generator if generator is not None else \
            torch.Generator(device=device).manual_seed(self.cfg.seed)

    def mode_loss(self, batch: tuple, mode: str) -> tuple[torch.Tensor, dict]:
        """Loss and metrics of one batch (``trainer.py:121-199``)."""
        cfg, model, gen = self.cfg, self.model, self.generator
        states, next_state, diffs, bc_mask, position_ids = batch
        moe_aux = [] if model.backbone_cfg.moe_experts > 0 else None
        if mode == "autoreg":
            input_states = states
            if cfg.noise is not None:
                std = diffs.std(dim=(-1, -2, -3, -4, -5), keepdim=True)
                noise = draw(torch.randn, states.shape, gen, states.device).to(states.dtype)
                input_states = states + noise * (~bc_mask).to(states.dtype) * std * cfg.noise
            pred_diff = model.predict_diffs(input_states, position_ids, train=True, generator=gen,
                                            moe_aux=moe_aux)
        elif mode == "gen":
            guide_img, _ = gen_seq(model, batch, states.shape[1] - 1)
            guide_img = guide_img.clone()  # out of inference mode, into autograd
            pred_diff = model.forward_see_init(img_to_patch(guide_img, model.ds_props),
                                               position_ids, train=True, generator=gen,
                                               moe_aux=moe_aux)
        elif mode == "notf":
            pred_state = gen_seq(model, batch, states.shape[1], grad=True,
                                 remat=cfg.parallel.remat, moe_aux=moe_aux)[0][:, 1:]
        else:
            raise ValueError(mode)

        with span("fluid.loss"):
            if mode == "autoreg":
                pred_state = patch_to_img(input_states, model.ds_props) + pred_diff
            elif mode == "gen":
                pred_state = guide_img + pred_diff
            next_img = patch_to_img(next_state, model.ds_props)
            mask_img = patch_to_img(bc_mask.float(), model.ds_props).bool()
            preds, target = pred_state, next_img
            if cfg.loss_norm_eps is not None:
                target, preds = normalise_states(diffs, next_img, pred_state, cfg.loss_norm_eps,
                                                 cfg.channel_independent)
            loss, metrics = combined_loss(preds, target, mask_img, cfg.loss_function,
                                          cfg.loss_weighting, cfg.pressure_weight)
            if moe_aux:
                aux = sum(moe_aux) / len(moe_aux)
                loss = loss + cfg.moe.aux_weight * aux
                metrics["moe_aux"] = aux
            metrics["loss"] = loss
            metrics["N_RMSE"] = calc_n_rmse(pred_state.detach(), next_img, mask_img)
            return loss, metrics

    def on_mesh(self, batch: tuple):
        """The context of a step over ``batch``, this rank's rows of the
        global batch: the loss's reductions over the batch axes and the
        draws of one process (nothing off a mesh, or with one batch rank)."""
        mesh = getattr(self.model, "mesh", None)
        if mesh is None or mesh.batch.size == 1:
            return nullcontext()
        stack = ExitStack()
        stack.enter_context(comm.batch_axes(mesh.batch))
        stack.enter_context(draw_shards(rows=mesh.rows(batch[0].shape[0] * mesh.batch.size)))
        return stack

    def _global(self, metrics: dict) -> dict:
        """Detached metrics, N-RMSE's rows joined over the batch axes."""
        out = {k: v.detach() for k, v in metrics.items()}
        out["N_RMSE"] = comm.batch_rows(out["N_RMSE"])
        return out

    def train_step(self, batch: tuple, mode: str = "autoreg") -> dict:
        """One optimizer step; returns the metrics, detached, on the device."""
        with span("fluid.train_step"):
            with span("fluid.optimizer"):
                self.opt.zero_grad(set_to_none=True)
            with self.on_mesh(batch):
                loss, metrics = self.mode_loss(batch, mode)
                with span("fluid.backward"):
                    loss.backward()
                metrics = self._global(metrics)
            with span("fluid.optimizer"):
                sync_grads(self.model)
                self.opt.step()
            return metrics

    def val_rollout(self, batch: tuple) -> tuple[torch.Tensor, torch.Tensor]:
        """Predicted and target image sequences of ``val_step``'s rollout
        (``trainer.py:233-242``; the figures of ``cfg.val_plot_dir``)."""
        states = batch[0]
        pred_states, _ = gen_seq(self.model, batch, states.shape[1])
        return pred_states[:, :-1], patch_to_img(states, self.model.ds_props)

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
        with self.on_mesh(batch):
            loss, metrics = combined_loss(pred_states, states_img, mask_img, cfg.loss_function,
                                          cfg.loss_weighting, cfg.pressure_weight)
            metrics["loss"] = loss
            metrics["N_RMSE"] = calc_n_rmse(pred_states, states_img, mask_img)
            return self._global(metrics)
