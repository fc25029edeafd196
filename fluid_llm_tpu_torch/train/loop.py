"""Epoch loop: run-mode selection, validation cadence, checkpoints, logging.

Counterpart of ``fluid_llm_tpu/train/loop.py:36-192`` (``src/main.py:43-172``):

- mode per epoch: autoreg until ``teacher_forcing.start_epoch``, then a
  ``tf_prob`` coin flip between autoreg and gen/notf (``main.py:43-59``);
- StepLR by the global epoch (``main.py:82``; resumes continue the decay);
- validation every 3 epochs (``main.py:116-118``);
- a checkpoint every ``save_model_each`` epochs (``main.py:133-143``) and
  after the final epoch if the cadence missed it;
- metrics aggregated as ``process_metrics`` (``src/utils.py:163``).

Training batches are built by ``cfg.num_workers`` threads
(``data.pipeline.make_batches``).  ``cfg.profile_dir`` captures a
``torch.profiler`` trace of the first epoch (Chrome trace format);
``cfg.val_plot_dir`` saves target-vs-prediction figures of the first
validation batch at each validation (``loop.py:51-80``; matplotlib needed).
"""

from __future__ import annotations

import logging
import os
import random as pyrandom
import time
from contextlib import nullcontext
from typing import Callable, Optional

import torch

from fluid_llm_tpu_torch.config import Config
from fluid_llm_tpu_torch.data.pipeline import PatchDataset, make_batches
from fluid_llm_tpu_torch.tools.plotting import save_val_plots
from fluid_llm_tpu_torch.train import checkpoint as ckpt
from fluid_llm_tpu_torch.train.optim import set_learning_rate, steplr
from fluid_llm_tpu_torch.train.trainer import Trainer
from fluid_llm_tpu_torch.utils import process_metrics

logger = logging.getLogger("fluid_llm_tpu_torch.train")


def select_run_mode(cfg: Config, epoch: int) -> tuple[str, str]:
    """(trainer mode, metric label), ``src/main.py:43-59``."""
    tf = cfg.teacher_forcing
    if tf.start_epoch != 0 and epoch < tf.start_epoch:
        return "autoreg", "Autoreg"
    if pyrandom.random() < tf.tf_prob:
        return "autoreg", "Autoreg"
    if tf.tf_mode in ("gen", "notf"):
        return tf.tf_mode, "Gen"
    raise ValueError(f"Invalid configuration {tf.tf_mode}")


def _profiler(profile_dir: str, device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    return torch.profiler.profile(
        activities=activities,
        on_trace_ready=lambda p: p.export_chrome_trace(os.path.join(profile_dir, "trace.json")),
    )


def _to_host(metrics: list[dict]) -> list[dict]:
    return [{k: v.cpu() for k, v in m.items()} for m in metrics]


def train_run(
    cfg: Config,
    trainer: Trainer,
    train_ds: PatchDataset,
    valid_ds: PatchDataset,
    save_path: str = "",
    start_ep: int = 0,
    log_fn: Optional[Callable[[dict, int], None]] = None,
) -> int:
    """Train ``cfg.num_epochs`` epochs from ``start_ep``; returns the next
    epoch index."""
    device = next(trainer.model.parameters()).device
    lr_schedule = steplr(cfg.learning_rate, cfg.schedule_epoch, cfg.schedule_gamma)
    st = time.time()

    for epoch_idx in range(cfg.num_epochs):
        epoch = epoch_idx + start_ep
        set_learning_rate(trainer.opt, lr_schedule(epoch))
        mode, run_mode = select_run_mode(cfg, epoch)

        profiling = cfg.profile_dir and epoch_idx == 0
        train_metrics = []
        with _profiler(cfg.profile_dir, device) if profiling else nullcontext():
            for batch in make_batches(train_ds, cfg.batch_size, shuffle=True, seed=epoch,
                                      device=device, num_workers=cfg.num_workers):
                # metrics stay on the device; one transfer at the epoch's end
                train_metrics.append(trainer.train_step(batch, mode))
            train_metrics = _to_host(train_metrics)

        train_log, loss, nrmse = process_metrics(train_metrics, run_mode, "train")
        train_log["lr"] = lr_schedule(epoch)

        if epoch_idx % 3 == 0:
            val_metrics, first_val = [], None
            for batch in make_batches(valid_ds, cfg.batch_size, shuffle=False, device=device):
                first_val = batch if first_val is None else first_val
                val_metrics.append(trainer.val_step(batch))
            val_log, val_loss, val_nrmse = process_metrics(_to_host(val_metrics), "Gen", "val")
            train_log.update(val_log)
            if cfg.val_plot_dir and first_val is not None:
                pred, true = trainer.val_rollout(first_val)
                save_val_plots(pred[0].cpu().numpy(), true[0].cpu().numpy(), cfg.val_plot_dir,
                               epoch)
        else:
            val_loss, val_nrmse = 0.0, 0.0

        if log_fn is not None:
            log_fn(train_log, epoch)

        t = time.time() - st
        st = time.time()
        logger.info(
            "Epoch %d: Training (Loss: %.4g | N_RMSE: %.5g) - "
            "Validation (Loss: %.4g | N_RMSE: %.5g)  Time: %.1f",
            epoch + 1, loss, nrmse, val_loss, val_nrmse, t,
        )

        if cfg.save_on and save_path and cfg.save_model_each > 0 \
                and epoch_idx % cfg.save_model_each == 0:
            path = ckpt.save_checkpoint(save_path, epoch, trainer.model, trainer.opt, epoch, cfg)
            logger.info("Saved checkpoint at epoch %d to %s", epoch, path)

    # the cadence fires only at multiples of ``save_model_each``: always
    # persist the final state unless the last epoch just saved
    # (``loop.py:174-190``); the epoch recorded is the one just completed
    if cfg.save_on and save_path and cfg.num_epochs > 0 and cfg.save_model_each > 0 \
            and (cfg.num_epochs - 1) % cfg.save_model_each != 0:
        last = start_ep + cfg.num_epochs - 1
        path = ckpt.save_checkpoint(save_path, last, trainer.model, trainer.opt, last, cfg)
        logger.info("Saved final checkpoint at epoch %d to %s", last, path)
    return start_ep + cfg.num_epochs
