"""Device selection, seeding, metric aggregation (counterpart of
``fluid_llm_tpu/utils``, without jax)."""

from __future__ import annotations

import random
from typing import Any, Iterable

import numpy as np
import torch


def get_device(name: str | torch.device = "cuda") -> torch.device:
    """The device ``name`` names; raises when CUDA is asked for and absent.

    Never falls back to the CPU: a run that asked for the card and did not
    get it must fail, not measure the host.
    """
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def set_seed(seed: int = 1234) -> torch.Generator:
    """Seed the host RNGs (dataset step sampling) and return a CPU
    ``torch.Generator`` for weight init (``src/utils.py:23-26``, default 1234)."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator(device="cpu").manual_seed(seed)


def process_metrics(
    metrics_per_epoch: list[dict[str, Any]], run_mode: str, prefix: str
) -> tuple[dict[str, float], float, float]:
    """Aggregate per-batch metric dicts (``src/utils.py:163-183``): scalar
    losses are averaged; N_RMSE is concatenated over batches, averaged per
    rollout step, then overall."""
    if not metrics_per_epoch:
        return {}, 0.0, 0.0
    out: dict[str, float] = {}
    loss = 0.0
    for key in metrics_per_epoch[0]:
        if key == "N_RMSE":
            continue
        out[f"{prefix}/{run_mode}/{key}"] = float(np.mean([float(m[key]) for m in metrics_per_epoch]))
        if key == "loss":
            loss = out[f"{prefix}/{run_mode}/{key}"]
    n_rmse = np.concatenate([np.asarray(m["N_RMSE"]) for m in metrics_per_epoch], axis=0)
    overall = float(n_rmse.mean(axis=0).mean())
    out[f"{prefix}/{run_mode}/N_RMSE"] = overall
    return out, loss, overall


def count_params(params: Iterable[torch.Tensor]) -> int:
    return sum(p.numel() for p in params)
