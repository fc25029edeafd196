"""Device selection and seeding (counterpart of ``fluid_llm_tpu/utils``)."""

from __future__ import annotations

import random

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
