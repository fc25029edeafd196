"""Training entry point (counterpart of ``fluid_llm_tpu/main.py:134-216``).

    python -m fluid_llm_tpu_torch.main --config_path configs/training1.yaml \\
        [--save_folder NAME] [--metrics_jsonl FILE] [--device cuda]

The weights are drawn from ``cfg.seed``; then the pretrained backbone
``llm_backbone`` is imported from the local HF cache where it is there
(``models/hf_import.load_pretrained``, no download), with the BOS vector
from its token table, as ``fluid_llm_tpu/main.py:83-99`` does; else the
random backbone stays, and the log says which.  The adapters, encoder,
decoder and BOS train on top, on the data the config's ``load_dir`` names
(the MGN cylinder or airfoil pickles, or synthetic trajectories:
``data.get_dataset``).  Every backbone the configs name builds: dense or
MoE (``moe.experts``, its balance loss in the loss), frozen under
LoRA/DoRA or ``freeze_llm`` as packed nf4 with ``llm_4bit_loading``
(``fluid_llm_tpu/main.py:101-110``, after the import) and in bf16 with
``frozen_bf16``; pipeline parallelism raises.  Metrics go to the log and,
optionally, a JSONL file.  The multi-process flags (``--distributed`` ...)
are not ported and raise.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import torch

from fluid_llm_tpu_torch.config import Config
from fluid_llm_tpu_torch.data import get_dataset
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.models.hf_import import bos_embedding, load_pretrained
from fluid_llm_tpu_torch.train import checkpoint as ckpt
from fluid_llm_tpu_torch.train.loop import train_run
from fluid_llm_tpu_torch.train.trainer import Trainer
from fluid_llm_tpu_torch.utils import count_params, get_device, set_seed

logger = logging.getLogger("fluid_llm_tpu_torch.main")


@torch.no_grad()
def import_pretrained(model: FluidLLM) -> bool:
    """Load ``cfg.llm_backbone``'s pretrained weights from the local HF
    cache into ``model.backbone`` (and, with ``use_bos_token``, the BOS
    vector from its token table), in place on the CPU.  DoRA's magnitudes
    keep the norms of the random draw, as in the JAX package
    (``fluid_llm_tpu/main.py:86-97``).  Returns whether it imported; the
    log says why not.  A MoE backbone has no dense MLP to take the weights,
    and a backbone built at other widths (``FluidLLM.build`` overrides)
    cannot take them: both keep their random draw."""
    cfg = model.cfg
    if model.backbone_cfg.moe_experts > 0:
        logger.info("Pretrained %s not imported: a MoE backbone (moe.experts %d) has no dense "
                    "MLP to take it; using random init", cfg.llm_backbone, cfg.moe.experts)
        return False
    loaded = load_pretrained(cfg.llm_backbone, cfg.llm_layers)
    if loaded is None:
        logger.info("Pretrained %s unavailable; using random init", cfg.llm_backbone)
        return False
    state, embed_tokens, bcfg = loaded
    shapes = {k: tuple(v.shape) for k, v in model.backbone.state_dict().items()}
    if shapes != {k: tuple(v.shape) for k, v in state.items()}:
        logger.info("Pretrained %s not imported: its widths (%s) differ from the model's "
                    "backbone (%s); using random init", cfg.llm_backbone, _widths(bcfg),
                    _widths(model.backbone_cfg))
        return False
    model.backbone.load_state_dict(state)
    if model.bos is not None:
        model.bos.copy_(bos_embedding(embed_tokens, bcfg))
    logger.info("Loaded pretrained backbone %s", cfg.llm_backbone)
    return True


def _widths(bcfg) -> str:
    return ", ".join(f"{f} {getattr(bcfg, f)}" for f in
                     ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "max_pos",
                      "d_embed"))


def build_model_and_trainer(cfg: Config, ds_props, device: torch.device, *,
                            pretrained: bool = True, **backbone_overrides) -> Trainer:
    """Model on ``device`` and its trainer (optimizer over the trainable
    parameters; ``frozen_bf16`` cast there), in the JAX order
    (``fluid_llm_tpu/main.py:83-110``): weights drawn from ``cfg.seed``;
    with ``pretrained``, the HF backbone imported over them
    (:func:`import_pretrained`); the frozen backbone quantized to nf4 with
    ``llm_4bit_loading`` (``FluidLLM.quantize_frozen``); moved.
    ``pretrained=False`` is the template ``continue_train`` restores into,
    which reads no backbone only to overwrite it.  ``backbone_overrides``
    go to ``FluidLLM.build`` (e.g. ``attn_impl="short"``)."""
    model = FluidLLM.build(cfg, ds_props, **backbone_overrides)
    model.init_weights(set_seed(cfg.seed))
    if pretrained:
        import_pretrained(model)
    if model.quantize_frozen():
        logger.info("Quantized backbone weights to packed nf4 storage")
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
    logger.info("The model has %d trainable parameters (%d frozen)",
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
