"""Training entry point (counterpart of ``fluid_llm_tpu/main.py:134-216``).

    python -m fluid_llm_tpu_torch.main --config_path configs/training1.yaml \\
        [--save_folder NAME] [--metrics_jsonl FILE] [--device cuda]

The backbone starts from random weights drawn from ``cfg.seed`` (pretrained
HF weights would need a download); the adapters, encoder, decoder and BOS
train on top.  Metrics go to the log and, optionally, a JSONL file.  The
multi-process flags (``--distributed`` ...) are not ported and raise.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import torch

from fluid_llm_tpu.config import Config
from fluid_llm_tpu_torch.data import get_dataset
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.train import checkpoint as ckpt
from fluid_llm_tpu_torch.train.loop import train_run
from fluid_llm_tpu_torch.train.trainer import Trainer
from fluid_llm_tpu_torch.utils import count_params, get_device, set_seed

logger = logging.getLogger("fluid_llm_tpu_torch.main")


def build_model_and_trainer(cfg: Config, ds_props, device: torch.device) -> Trainer:
    """Model with weights drawn from ``cfg.seed`` on ``device``, and its
    trainer (optimizer over the trainable parameters)."""
    model = FluidLLM.build(cfg, ds_props)
    model.init_weights(set_seed(cfg.seed))
    model.to(device)
    return Trainer(model)


def jsonl_sink(path: str):
    """``log_fn`` appending one JSON line per epoch to ``path``."""
    def log(metrics: dict, epoch: int) -> None:
        with open(path, "a") as f:
            f.write(json.dumps({"epoch": epoch, **metrics}) + "\n")
    return log


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config_path", default="configs/training1.yaml")
    parser.add_argument("--save_folder", default=None)
    parser.add_argument("--metrics_jsonl", default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--distributed", action="store_true",
                        help="multi-process training (not ported)")
    parser.add_argument("--coordinator_address", default=None)
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(name)s:%(levelname)s] %(message)s")
    if args.distributed or any(a is not None for a in
                               (args.coordinator_address, args.num_processes, args.process_id)):
        raise NotImplementedError("multi-process training is not ported")

    cfg = Config.from_yaml(args.config_path)
    logger.info("Parameters for training: %s", cfg.to_dict())
    train_ds = get_dataset(cfg.replace(seq_len=cfg.autoreg_seq_len), mode="train")
    valid_ds = get_dataset(cfg.replace(seq_len=cfg.val_seq_len), mode="valid")
    trainer = build_model_and_trainer(cfg, train_ds.ds_props(), get_device(args.device))
    params = list(trainer.model.parameters())
    logger.info("Backbone %s with random weights (seed %d); %d trainable parameters "
                "(%d frozen)", cfg.llm_backbone, cfg.seed,
                count_params(p for p in params if p.requires_grad),
                count_params(p for p in params if not p.requires_grad))

    save_path = ""
    if cfg.save_on:
        save_path = ckpt.make_save_folder(cfg.checkpoint_save_path, args.save_folder)
        cfg.to_yaml(f"{save_path}/config.yaml")
        logger.info("Saving checkpoints to: %s", save_path)
    log_fn = jsonl_sink(args.metrics_jsonl) if args.metrics_jsonl else None
    return train_run(cfg, trainer, train_ds, valid_ds, save_path, log_fn=log_fn)


if __name__ == "__main__":
    main(sys.argv[1:])
