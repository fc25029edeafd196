"""Grid-image datasets for DilResNet (mesh -> grid windows on the fly).

Counterpart of ``fluid_llm_tpu/data/grid_images.py``: ``eagle/Dataloader/
IMG_MGN.py`` (cylinder/airfoil trajectories resampled to the grid per
window through ``core/interp.resample_to_grid``, an optional crop of the
outer ring, fixed per-dataset normalisation, ``IMG_MGN.py:141-157``) and
the pre-rendered EAGLE images (``IMG_Eagle.py``).  Windows are numpy,
NHWC.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np
import torch

from fluid_llm_tpu_torch.core.interp import resample_to_grid
from fluid_llm_tpu_torch.data.pipeline import PatchDataset

CYL_MEANS, CYL_STDS = (0.823, 0.0005865, 0.04763), (0.275, 0.275, 0.275)
AIR_MEANS, AIR_STDS = (170.1, -1.183, 9.935e4), (71.06, 46.73, 8964.0)


class GridImageDataset:
    """Grid windows ``(T, H, W, 3)`` and the boundary mask ``(T, H, W)`` of
    a :class:`PatchDataset`'s trajectories (random start in train, step 100
    otherwise)."""

    def __init__(self, source: PatchDataset, window_length: int = 6, mode: str = "train",
                 means=CYL_MEANS, stds=CYL_STDS, crop: int = 0, seed: int = 1234):
        self.source = source
        self.window_length = window_length
        self.mode = mode
        self.means = np.asarray(means, np.float32)
        self.stds = np.asarray(stds, np.float32)
        self.crop = crop
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return self.source.num_trajectories()

    def __getitem__(self, item: int):
        src = self.source.get_trajectory(item)
        max_start = src.node_states.shape[0] - self.window_length
        t = 100 if self.mode != "train" else int(self._rng.integers(0, max_start + 1))
        t = min(t, max_start)
        grid = resample_to_grid(
            torch.from_numpy(np.ascontiguousarray(src.node_states[t:t + self.window_length])),
            torch.from_numpy(src.vert_idx), torch.from_numpy(src.weights),
            torch.from_numpy(src.mask),
        ).numpy()  # (T, 3, H, W)
        mask = np.broadcast_to(src.mask, (self.window_length,) + src.mask.shape)
        if self.crop:
            c = self.crop
            grid = grid[:, :, c:-c, c:-c]
            mask = mask[:, c:-c, c:-c]
        state = (grid - self.means[None, :, None, None]) / self.stds[None, :, None, None]
        return np.moveaxis(state, 1, -1), mask.copy()


class EagleImageDataset:
    """Pre-rendered EAGLE grid images (``eagle/Dataloader/IMG_Eagle.py``):
    per trajectory ``states.npy`` (T, H, W, C) and the ``pixel_type.npy``
    mask; val/test windows start at step 550."""

    MEANS = (-0.0015, 0.2211, -0.8322)
    STDS = (1.7970, 2.0258, 7.4013)

    def __init__(self, data_path: str, mode: str = "train", window_length: int = 10,
                 seed: int = 1):
        if mode not in ("train", "valid", "test"):
            raise ValueError(f"mode {mode!r}")
        self.dataloc = sorted(r for r, _, fs in os.walk(data_path) if "states.npy" in fs)
        if not self.dataloc:
            raise FileNotFoundError(f"No states.npy under {data_path}")
        self.mode = mode
        self.window_length = window_length
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.dataloc)

    def __getitem__(self, item: int):
        T = self.window_length
        t = 1 if T == 990 else int(self._rng.integers(1, 990 - T + 1))
        if self.mode in ("test", "valid") and T != 990:
            t = 550
        states = np.load(os.path.join(self.dataloc[item], "states.npy"), mmap_mode="r")
        mask = np.load(os.path.join(self.dataloc[item], "pixel_type.npy"), mmap_mode="r")
        window = np.asarray(states[t:t + T], np.float32)
        means = np.asarray(self.MEANS, np.float32)[: window.shape[-1]]
        stds = np.asarray(self.STDS, np.float32)[: window.shape[-1]]
        m = np.broadcast_to(np.asarray(mask, bool), (T,) + np.asarray(mask).shape[-2:])
        return (window - means) / stds, m.copy()


def iterate_image_batches(dataset, batch_size: int, *, shuffle: bool,
                          seed: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """(state (B, T, H, W, C), mask (B, T, H, W)) batches."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for i in range(0, len(order), batch_size):
        samples = [dataset[int(j)] for j in order[i:i + batch_size]]
        yield np.stack([s[0] for s in samples]), np.stack([s[1] for s in samples])
