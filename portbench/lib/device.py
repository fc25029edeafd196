"""The card: the look for it, its name and readings, and the memory peak.

A measurement path that finds no card, or fewer than the cell asks for,
fails: it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess

import torch


class NoDevice(RuntimeError):
    pass


def require_cuda(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false: this benchmark measures the card "
                       "and has no CPU path")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards, torch sees "
                       f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def smi(fields: str = "name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu") -> str:
    """One ``nvidia-smi`` reading of the first card, or why there is none."""
    try:
        res = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader",
                              "--id=0"], capture_output=True, text=True, timeout=30)
        return (res.stdout or res.stderr).strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not available ({e.__class__.__name__})"


def info(device: torch.device, chips: int) -> dict:
    """The result line's ``device`` object, without the peak."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
