"""Resume training from a saved checkpoint (counterpart of
``fluid_llm_tpu/continue_train.py:27-70``).

    python -m fluid_llm_tpu_torch.continue_train --checkpoint_dir model_checkpoints \\
        [--load_no -1] [--step N] [--metrics_jsonl FILE] [--device cuda]

The run is selected by folder index (latest by default), its saved YAML is
reread, model and optimizer state restored, and training re-enters the
epoch loop at the saved epoch.  The template is ``main``'s without the
pretrained import (``build_model_and_trainer(pretrained=False)``, as the
JAX package restores into ``init_state_and_mesh``'s random state): every
weight comes from the checkpoint.  A run over a quantized
(``llm_4bit_loading``) or bf16 (``frozen_bf16``) frozen backbone restores
that storage bit for bit.  With ``--distributed`` (``parallel/launch.py``)
the template is cut to this rank's part of the saved config's mesh and
the checkpoint restored onto it, whatever mesh (or one process) wrote it,
as the JAX package restores into ``init_state_and_mesh``
(``fluid_llm_tpu/continue_train.py:46-55``).
"""

from __future__ import annotations

import argparse
import logging
import sys

from fluid_llm_tpu_torch.data import get_dataset
from fluid_llm_tpu_torch.main import build_model_and_trainer, jsonl_sink
from fluid_llm_tpu_torch.parallel import launch
from fluid_llm_tpu_torch.train import checkpoint as ckpt
from fluid_llm_tpu_torch.train.loop import train_run

logger = logging.getLogger("fluid_llm_tpu_torch.continue_train")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--checkpoint_dir", default="model_checkpoints")
    parser.add_argument("--load_no", type=int, default=-1)
    parser.add_argument("--step", type=int, default=None)
    parser.add_argument("--metrics_jsonl", default=None,
                        help="append per-epoch metrics to this JSONL (as main --metrics_jsonl)")
    parser.add_argument("--device", default="cuda")
    launch.add_arguments(parser)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(name)s:%(levelname)s] %(message)s")
    device = launch.init(args, parser)
    try:
        return _resume(args, device)
    finally:
        launch.finish()


def _resume(args, device) -> int:

    load_path = ckpt.get_save_folder(args.checkpoint_dir, args.load_no)
    cfg = ckpt.load_config(load_path)
    step = args.step if args.step is not None else ckpt.latest_step(load_path)
    logger.info("Resuming from %s step_%s", load_path, step)

    train_ds = get_dataset(cfg.replace(seq_len=cfg.autoreg_seq_len), mode="train")
    valid_ds = get_dataset(cfg.replace(seq_len=cfg.val_seq_len), mode="valid")
    trainer = build_model_and_trainer(cfg, train_ds.ds_props(), device, pretrained=False)
    epoch = ckpt.restore_checkpoint(load_path, step, trainer.model, trainer.opt)
    log_fn = jsonl_sink(args.metrics_jsonl) if args.metrics_jsonl else None
    return train_run(cfg, trainer, train_ds, valid_ds, save_path=load_path, start_ep=epoch,
                     log_fn=log_fn)


if __name__ == "__main__":
    main(sys.argv[1:])
