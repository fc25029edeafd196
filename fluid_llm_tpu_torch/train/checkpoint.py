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
  JAX package's trainable/frozen partition), the optimizer's state dict
  (with adafactor its factored moments and step; with
  ``grad_accum_steps > 1`` also the micro-step and the running mean of the
  gradients, ``optim.MultiSteps``, so a resume continues mid-accumulation)
  and the epoch; plus ``step_N.epoch`` beside it, as the JAX package writes.
  The frozen part holds every buffer too: the nf4 codes (uint8) and
  absmax chain, int8 ``q``/``scale`` (MoE expert banks included) and bf16
  parameters under ``frozen_bf16``, each in its dtype, so a template of the
  same structure (``main.build_model_and_trainer``) restores them bit for
  bit.

Restoring reads tensors only (``weights_only=True``).

On a rank mesh (``model.mesh``, ``parallel/mesh.py``) every rank takes part
in gathering the whole tensors and the optimizer state (in the one-process
order of the trainable parameters), and rank 0 writes the same files as
one process; a restore cuts the whole tensors to what this rank of any
mesh holds.  So a run trained on a mesh resumes in one process, and a
one-process run resumes on a mesh (the JAX package's Orbax restore onto
the template's shardings, ``fluid_llm_tpu/train/checkpoint.py:7-8``).
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch
import torch.distributed

from fluid_llm_tpu_torch.config import Config

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


def save_checkpoint(save_path: str, step: int, model: torch.nn.Module, optimizer, epoch: int,
                    cfg: Config) -> str:
    path = os.path.abspath(os.path.join(save_path, f"step_{step}"))
    mesh = getattr(model, "mesh", None)
    if mesh is not None:
        from fluid_llm_tpu_torch.parallel.mesh import full_optimizer_state, full_state_dict

        state = full_state_dict(model)
        opt_state = full_optimizer_state(optimizer, model)
        if mesh.rank != 0:
            torch.distributed.barrier()  # until rank 0 has written
            return path
        trainable = set(model.trainable_names)
        payload = {
            "trainable": {n: state[n] for n in model.trainable_names},
            "frozen": {n: t for n, t in state.items() if n not in trainable},
            "optimizer": opt_state,
            "epoch": epoch,
        }
    else:
        params = dict(model.named_parameters())
        payload = {
            "trainable": {n: p.detach() for n, p in params.items() if p.requires_grad},
            "frozen": {n: t for n, t in model.state_dict().items()
                       if n not in params or not params[n].requires_grad},
            "optimizer": optimizer.state_dict(),
            "epoch": epoch,
        }
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"{STATE_FILE}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    cfg.to_yaml(os.path.join(save_path, "config.yaml"))
    with open(os.path.join(save_path, f"step_{step}.epoch"), "w") as f:
        f.write(str(epoch))
    if mesh is not None:
        torch.distributed.barrier()
    return path


def restore_checkpoint(save_path: str, step: int, model: torch.nn.Module,
                       optimizer=None) -> int:
    """Load ``step_N`` into ``model`` (every tensor of its state dict, on
    its device; on a mesh, this rank's chunks) and, if given,
    ``optimizer``; returns the saved epoch."""
    device = next(model.parameters()).device
    payload = torch.load(os.path.join(save_path, f"step_{step}", STATE_FILE),
                         map_location=device, weights_only=True)
    state = {**payload["trainable"], **payload["frozen"]}
    if getattr(model, "mesh", None) is None:
        model.load_state_dict(state)
        if optimizer is not None:
            optimizer.load_state_dict(payload["optimizer"])
    else:
        from fluid_llm_tpu_torch.parallel.mesh import load_optimizer_state, local_state_dict

        model.load_state_dict(local_state_dict(model, state))
        if optimizer is not None:
            load_optimizer_state(optimizer, model, payload["optimizer"])
    return int(payload["epoch"])


def load_config(save_path: str) -> Config:
    return Config.from_yaml(os.path.join(save_path, "config.yaml"))
