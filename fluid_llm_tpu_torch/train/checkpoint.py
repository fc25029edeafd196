"""Checkpoints in a torch format, with the JAX package's folder conventions.

Counterpart of ``fluid_llm_tpu/train/checkpoint.py`` (which writes Orbax,
unreadable without jax).  The reference saves ``{params, state_dict,
optimizer, scheduler}`` every ``save_model_each`` epochs
(``src/main.py:133-143``) and rereads the YAML copied next to the
checkpoints on resume and inference.  Here:

- numbered run folders (``make_save_folder``/``get_save_folder``,
  ``src/utils.py:128-160``) holding ``config.yaml``;
- a checkpoint ``step_N/`` (a folder, as Orbax's) holding ``state.pt``:
  ``{"trainable", "frozen", "optimizer", "epoch"}`` written with
  ``torch.save`` -- the model's parameters split by ``requires_grad`` (the
  JAX package's trainable/frozen partition), the optimizer's state dict and
  the epoch; plus ``step_N.epoch`` beside it, as the JAX package writes.

Restoring reads tensors only (``weights_only=True``).
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from fluid_llm_tpu.config import Config

STATE_FILE = "state.pt"


def make_save_folder(base: str, name: Optional[str] = None, save_on: bool = True) -> str:
    """Create a numbered run folder (``src/utils.py:128-146``)."""
    if not save_on:
        return ""
    os.makedirs(base, exist_ok=True)
    if name is None:
        existing = [d for d in os.listdir(base) if re.fullmatch(r"\d+", d)]
        name = f"{max((int(d) for d in existing), default=-1) + 1:03d}"
    path = os.path.join(base, name)
    os.makedirs(path, exist_ok=True)
    return path


def get_save_folder(base: str, idx: int = -1) -> str:
    """Look up a run folder by (natsorted) index (``src/utils.py:148-160``)."""
    runs = sorted(
        (d for d in os.listdir(base) if os.path.isdir(os.path.join(base, d))),
        key=lambda d: [int(c) if c.isdigit() else c for c in re.split(r"(\d+)", d)],
    )
    if not runs:
        raise FileNotFoundError(f"No runs in {base}")
    return os.path.join(base, runs[idx])


def latest_step(save_path: str) -> Optional[int]:
    steps = [
        int(m.group(1))
        for d in os.listdir(save_path)
        if (m := re.fullmatch(r"step_(\d+)", d)) and os.path.isdir(os.path.join(save_path, d))
    ]
    return max(steps) if steps else None


def save_checkpoint(save_path: str, step: int, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, epoch: int, cfg: Config) -> str:
    path = os.path.abspath(os.path.join(save_path, f"step_{step}"))
    os.makedirs(path, exist_ok=True)
    params = dict(model.named_parameters())
    payload = {
        "trainable": {n: p.detach() for n, p in params.items() if p.requires_grad},
        "frozen": {n: t for n, t in model.state_dict().items()
                   if n not in params or not params[n].requires_grad},
        "optimizer": optimizer.state_dict(),
        "epoch": epoch,
    }
    tmp = os.path.join(path, f"{STATE_FILE}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    cfg.to_yaml(os.path.join(save_path, "config.yaml"))
    with open(os.path.join(save_path, f"step_{step}.epoch"), "w") as f:
        f.write(str(epoch))
    return path


def restore_checkpoint(save_path: str, step: int, model: torch.nn.Module,
                       optimizer: Optional[torch.optim.Optimizer] = None) -> int:
    """Load ``step_N`` into ``model`` (every tensor of its state dict, on
    its device) and, if given, ``optimizer``; returns the saved epoch."""
    device = next(model.parameters()).device
    payload = torch.load(os.path.join(save_path, f"step_{step}", STATE_FILE),
                         map_location=device, weights_only=True)
    model.load_state_dict({**payload["trainable"], **payload["frozen"]})
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])
    return int(payload["epoch"])


def load_config(save_path: str) -> Config:
    return Config.from_yaml(os.path.join(save_path, "config.yaml"))
