"""Inference entry point: the 251-step rollout protocol on the card.

Counterpart of ``fluid_llm_tpu/inference.py`` (``src/inference.py:27-191``):
build the test dataset at ``seq_len=253``, autoregressively generate
``pred_steps=251`` from 1 context state (bs=1), report per-step and mean
N-RMSE.

With ``--streaming`` the rollout is the KV-cache streaming one
(``rollout/streaming.py``; rope backbones with ``rope_abs`` embeddings and
absolute time, as ``configs/flagship_llama.yaml``).  A MoE backbone rolls
out either way: exact with its final block whole, streaming with each
decode chunk routed alone.  ``FLUID_SCAN_LAYERS=1``
in the environment serves either from the stacked-layer layout
(``FluidLLM.prepare_inference_params``).

``--plot_dir`` saves predicted frames of the first trajectory at rollout
steps 0, 20, ..., 100 (``inference.py:85-100``; needs matplotlib, which
only figures need).

With ``--checkpoint_dir`` the model comes from a run folder written by
``main``/``continue_train`` (torch checkpoints, ``train/checkpoint.py``):
its ``config.yaml`` and ``step_N`` (latest by default), as the JAX entry
point restores its Orbax ones.  Without it, the model is built from
``--config_path`` with random weights drawn from ``--seed``.

    python -m fluid_llm_tpu_torch.inference --checkpoint_dir model_checkpoints --load_no -1
    python -m fluid_llm_tpu_torch.inference --config_path configs/training1.yaml \\
        --load_dir synthetic:1
    python -m fluid_llm_tpu_torch.inference --config_path configs/flagship_llama.yaml \\
        --load_dir synthetic:1 --streaming
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
import sys

import numpy as np
import torch

from fluid_llm_tpu_torch.config import Config
from fluid_llm_tpu_torch.data import get_dataset, make_batches
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.ops.patching import patch_to_img
from fluid_llm_tpu_torch.rollout.generate import gen_seq
from fluid_llm_tpu_torch.rollout.streaming import gen_seq_streaming
from fluid_llm_tpu_torch.tools.plotting import save_rollout_plots
from fluid_llm_tpu_torch.train import checkpoint as ckpt
from fluid_llm_tpu_torch.train.metrics import calc_n_rmse
from fluid_llm_tpu_torch.utils import get_device, set_seed

logger = logging.getLogger("fluid_llm_tpu_torch.inference")


@torch.inference_mode()
def test_generate(
    model: FluidLLM,
    dataset,
    batch_size: int = 1,
    pred_steps: int = 251,
    ctx_states: int = 1,
    streaming: bool = False,
    plot_dir: str | None = None,
) -> tuple[np.ndarray, float]:
    """``src/inference.py:82-147``; returns (per-step N-RMSE, mean).

    Batches go to the device of the model's parameters.  ``streaming``
    serves through the KV-cache rollout (``rollout/streaming.py``);
    ``plot_dir``: figures of the first trajectory's rollout.
    """
    device = next(model.parameters()).device
    roll = gen_seq_streaming if streaming else gen_seq
    end_state = pred_steps + ctx_states - 1
    n_rmses, first = [], None
    for i, batch in enumerate(make_batches(dataset, batch_size, shuffle=False, device=device)):
        states, _, _, bc_mask, _ = batch
        pred_states, _ = roll(model, batch, pred_steps, start_state=ctx_states)
        pred_states = pred_states[:, :-1]  # last state has no diff
        true_states = patch_to_img(states, model.ds_props)[:, :end_state]
        mask_img = patch_to_img(bc_mask.float(), model.ds_props).bool()[:, :end_state]
        n_rmses.append(calc_n_rmse(pred_states, true_states, mask_img).cpu().numpy())
        if plot_dir and first is None:
            first = (pred_states[0].cpu().numpy(), true_states[0].cpu().numpy())
        logger.info("trajectory batch %d done", i)

    n_rmses = np.concatenate(n_rmses, axis=0)
    per_step = n_rmses.mean(axis=0)[ctx_states - 1:]
    mean = float(per_step.mean())
    logger.info("Standard N_RMSE: %s, Mean: %.4g", np.array2string(per_step, precision=4), mean)
    if first is not None:
        save_rollout_plots(*first, plot_dir)
    return per_step, mean


def build_seeded_model(cfg: Config, seed: int, device: torch.device,
                       **backbone_overrides) -> FluidLLM:
    """The model for ``cfg`` with random weights from ``seed``, prepared for
    inference on ``device`` (stacked with ``FLUID_SCAN_LAYERS=1``).  No
    pretrained import: a seeded model is a test of the path, not of
    weights, and the JAX inference entry never imports either
    (``fluid_llm_tpu/inference.py:137-151``); trained weights come from
    ``--checkpoint_dir``.
    Geometry comes from the train-time dataset config
    (``inference.py:173-174``); ``backbone_overrides`` go to
    ``FluidLLM.build`` (e.g. ``attn_impl="short"``)."""
    probe_ds = get_dataset(cfg.replace(seq_len=cfg.autoreg_seq_len), mode="valid")
    model = FluidLLM.build(cfg, probe_ds.ds_props(), **backbone_overrides)
    model.init_weights(set_seed(seed))
    model.quantize_frozen()
    model.to(device)
    model.prepare_inference_params()
    return model.eval()


def load_checkpoint_model(load_path: str, step: int, device: torch.device,
                          quant: str | None = None, qmm_mode: str = "w8a16") -> FluidLLM:
    """The model of run folder ``load_path`` at ``step_<step>``, prepared
    for inference on ``device`` (``fluid_llm_tpu/inference.py:138-161``);
    ``quant``/``qmm_mode``: quantized backbone storage (serving,
    ``FluidLLM.prepare_inference_params``; a MoE backbone's expert banks
    too).  A run trained over an nf4 frozen backbone restores into an nf4
    template (``FluidLLM.quantize_frozen``); its adapters merge into the
    dequantised weights."""
    cfg = ckpt.load_config(load_path)
    probe_ds = get_dataset(cfg.replace(seq_len=cfg.autoreg_seq_len), mode="valid")
    model = FluidLLM.build(cfg, probe_ds.ds_props())
    model.quantize_frozen()
    model.to(device)
    ckpt.restore_checkpoint(load_path, step, model)
    model.prepare_inference_params(quant, qmm_mode)
    return model.eval()


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="251-step rollout of a FluidLLM on the card, from a checkpoint "
        "(--checkpoint_dir) or with random weights drawn from --seed (--config_path)."
    )
    parser.add_argument("--checkpoint_dir", default=None,
                        help="folder of training runs; omit for seeded random weights")
    parser.add_argument("--load_no", type=int, default=-1, help="run folder index")
    parser.add_argument("--step", type=int, default=None, help="checkpoint step (default: latest)")
    parser.add_argument("--config_path", default="configs/training1.yaml")
    parser.add_argument("--load_dir", default=None,
                        help="override the config's dataset (a pickle folder or synthetic[:<n>])")
    parser.add_argument("--seed", type=int, default=1234, help="weight-init seed")
    parser.add_argument("--seq_len", type=int, default=253)
    parser.add_argument("--pred_steps", type=int, default=251)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--csv", default=None, help="write per-step N-RMSE CSV")
    parser.add_argument("--plot_dir", default=None,
                        help="save rollout frames of the first trajectory (needs matplotlib)")
    parser.add_argument("--streaming", action="store_true",
                        help="serve via the KV-cache streaming rollout (rope backbones only)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(name)s:%(levelname)s] %(message)s")

    device = get_device(args.device)
    if args.checkpoint_dir is not None:
        set_seed()
        load_path = ckpt.get_save_folder(args.checkpoint_dir, args.load_no)
        step = args.step if args.step is not None else ckpt.latest_step(load_path)
        logger.info("Loading checkpoint from: %s step_%s", load_path, step)
        model = load_checkpoint_model(load_path, step, device)
        cfg = model.cfg
        if args.load_dir is not None:
            cfg = cfg.replace(load_dir=args.load_dir)
    else:
        cfg = Config.from_yaml(args.config_path)
        if args.load_dir is not None:
            cfg = cfg.replace(load_dir=args.load_dir)
        model = build_seeded_model(cfg, args.seed, device)
    test_ds = get_dataset(cfg.replace(seq_len=args.seq_len), mode="test")
    per_step, mean = test_generate(
        model, test_ds, batch_size=args.batch_size, pred_steps=args.pred_steps,
        streaming=args.streaming, plot_dir=args.plot_dir,
    )
    if args.csv:
        if os.path.dirname(args.csv):
            os.makedirs(os.path.dirname(args.csv), exist_ok=True)
        with open(args.csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["step", "n_rmse"])
            for s, v in enumerate(per_step):
                w.writerow([s, float(v)])
        logger.info("wrote %s", args.csv)
    return mean


if __name__ == "__main__":
    main(sys.argv[1:])
