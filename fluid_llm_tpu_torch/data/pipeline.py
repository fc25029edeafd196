"""Shared dataset pipeline: window -> grid -> pad -> patch -> normalize.

Counterpart of ``fluid_llm_tpu/data/pipeline.py``; reproduces the sample
layout of ``MGNDataset.ds_get`` (``src/dataloader/simple_dataloader.py:72-102``).
Each sample is

    (input_states, next_state, diffs, bc_mask, position_ids)

with patch tensors ``(seq_len-1, N_patch, 3, px, py)`` and position ids
``(seq_len-1, N_patch, 3)``, as CPU tensors; batches move to the model's
device in :func:`make_batches`.  Only the cylinder protocol is ported; the
airfoil switches (flip, trim, masked normalisation) come with that dataset.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from fluid_llm_tpu_torch.core.interp import resample_to_grid
from fluid_llm_tpu_torch.data.ds_props import DSProps
from fluid_llm_tpu_torch.ops.patching import num_patches


def pad_amounts(h: int, w: int, patch: tuple[int, int]) -> tuple[tuple[int, int], tuple[int, int]]:
    """Centered pad-to-patch-multiple (``simple_dataloader.py:137-152``)."""
    pw = -h % patch[0]
    ph = -w % patch[1]
    return (pw // 2, pw - pw // 2), (ph // 2, ph - ph // 2)


def window_to_patches(
    grid_states: torch.Tensor,
    grid_mask: torch.Tensor,
    means: torch.Tensor,
    stds: torch.Tensor,
    *,
    patch: tuple[int, int],
    pad_x: tuple[int, int],
    pad_y: tuple[int, int],
):
    """(seq, 3, H, W) grid window -> reference sample tuple (without ids).

    grid_mask: (H, W) bool (True outside mesh).  Padding pixels get mask=1
    and state=0 (``simple_dataloader.py:137-152``); normalisation uses fixed
    per-dataset stats (``:193-216``), applied on the grid before the diffs.
    """
    seq = grid_states.shape[0]
    px, py = patch
    states = torch.nn.functional.pad(grid_states, (*pad_y, *pad_x))
    mask = torch.nn.functional.pad(grid_mask, (*pad_y, *pad_x), value=True)
    H, W = states.shape[-2:]
    nx, ny = H // px, W // py

    states = (states - means[None, :, None, None]) / stds[None, :, None, None]

    # patchify: (seq, 3, H, W) -> (seq, N_patch, 3, px, py)
    s = states.reshape(seq, 3, nx, px, ny, py).permute(0, 2, 4, 1, 3, 5)
    s = s.reshape(seq, nx * ny, 3, px, py)
    m = mask.reshape(nx, px, ny, py).permute(0, 2, 1, 3).reshape(nx * ny, px, py)

    input_states = s[:-1]
    next_state = s[1:]
    diffs = s[1:] - s[:-1]
    bc_mask = m[None, :, None].expand(seq - 1, nx * ny, 3, px, py)
    return input_states, next_state, diffs, bc_mask


def position_ids(seq_len_m1: int, nx_patch: int, ny_patch: int, t_base: int = 0,
                 t_step: int = 1) -> torch.Tensor:
    """``simple_dataloader.py:218-226``, reproduced exactly, including the
    quirky x-fastest labelling that doesn't match the y-fastest patch order
    (harmless: the embeddings are learned per index).  int64 (seq, N, 3).

    ``t_base``/``t_step``: (0, 1) gives the reference's window-relative time
    ids; the absolute-time variant (``Config.absolute_time_ids``) passes the
    window's trajectory step and ``seq_interval``, so every frame carries
    its raw trajectory step (``fluid_llm_tpu/data/pipeline.py:101-119``)."""
    n_patch = nx_patch * ny_patch
    arange = torch.arange(seq_len_m1 * n_patch)
    x_idx = arange % nx_patch
    y_idx = (arange // nx_patch) % ny_patch
    t_idx = (arange // n_patch) * t_step + t_base
    return torch.stack([x_idx, y_idx, t_idx], dim=1).reshape(seq_len_m1, n_patch, 3)


@dataclass
class TrajectorySource:
    """Precomputed per-trajectory resampling data + node states."""

    vert_idx: np.ndarray
    weights: np.ndarray
    mask: np.ndarray
    node_states: np.ndarray  # (n_steps, 3, N_nodes) float32 (Vx, Vy, P)


class PatchDataset:
    """Common base for cylinder-protocol datasets.

    Subclasses provide trajectories; this class handles window selection
    (random step in train, fixed step 100 for val/test,
    ``simple_dataloader.py:67-69``), resample + patchify and position ids.
    """

    def __init__(
        self,
        resolution: int,
        patch_size: tuple[int, int],
        seq_len: int,
        seq_interval: int = 1,
        mode: str = "train",
        normalize: bool = True,
        means: Sequence[float] = (0.0, 0.0, 0.0),
        stds: Sequence[float] = (1.0, 1.0, 1.0),
        max_steps: int = 600,
        seed: int = 1234,
        absolute_time: bool = False,
    ):
        if mode not in ("train", "valid", "test"):
            raise ValueError(f"mode {mode!r}")
        self.mode = mode
        self.absolute_time = absolute_time
        self.resolution = resolution
        self.patch_size = tuple(patch_size)
        self.seq_len = seq_len
        self.seq_interval = seq_interval
        self.max_step_num = max_steps - seq_len * seq_interval
        self.means = torch.tensor(means if normalize else (0.0,) * 3, dtype=torch.float32)
        self.stds = torch.tensor(stds if normalize else (1.0,) * 3, dtype=torch.float32)
        self._rng = np.random.default_rng(seed)
        self._geom: Optional[tuple] = None  # (pad_x, pad_y, Nx, Ny), probed lazily

    def num_trajectories(self) -> int:
        raise NotImplementedError

    def get_trajectory(self, idx: int) -> TrajectorySource:
        raise NotImplementedError

    def _probe(self):
        if self._geom is None:
            src = self.get_trajectory(min(1, self.num_trajectories() - 1))
            h, w = src.mask.shape
            pad_x, pad_y = pad_amounts(h, w, self.patch_size)
            nx = num_patches(h + sum(pad_x), self.patch_size[0], self.patch_size[0])
            ny = num_patches(w + sum(pad_y), self.patch_size[1], self.patch_size[1])
            self._geom = (pad_x, pad_y, nx, ny)
        return self._geom

    @property
    def N_x_patch(self) -> int:
        return self._probe()[2]

    @property
    def N_y_patch(self) -> int:
        return self._probe()[3]

    @property
    def N_patch(self) -> int:
        return self.N_x_patch * self.N_y_patch

    def ds_props(self) -> DSProps:
        return DSProps(
            Nx_patch=self.N_x_patch,
            Ny_patch=self.N_y_patch,
            patch_size=self.patch_size,
            seq_len=self.seq_len - 1,
        )

    def __len__(self) -> int:
        return self.num_trajectories()

    def sample(self, idx: int, step_num: Optional[int] = None):
        if step_num is None:
            step_num = (
                100
                if self.mode in ("valid", "test")
                else int(self._rng.integers(0, self.max_step_num + 1))
            )
        src = self.get_trajectory(idx)
        pad_x, pad_y, nx, ny = self._probe()
        steps = np.arange(
            step_num, step_num + self.seq_len * self.seq_interval, self.seq_interval
        )
        mask = torch.from_numpy(src.mask)
        grid = resample_to_grid(
            torch.from_numpy(src.node_states[steps]), torch.from_numpy(src.vert_idx),
            torch.from_numpy(src.weights), mask,
        )
        input_states, next_state, diffs, bc_mask = window_to_patches(
            grid, mask, self.means, self.stds,
            patch=self.patch_size, pad_x=pad_x, pad_y=pad_y,
        )
        pos = position_ids(
            self.seq_len - 1, nx, ny,
            t_base=step_num if self.absolute_time else 0,
            t_step=self.seq_interval if self.absolute_time else 1,
        )
        return input_states, next_state, diffs, bc_mask, pos

    def __getitem__(self, idx: int):
        return self.sample(idx)


def make_batches(
    dataset,
    batch_size: int,
    *,
    shuffle: bool,
    seed: int = 0,
    drop_last: bool = False,
    device: torch.device | str = "cpu",
) -> Iterator[tuple]:
    """Serial host batcher: stacks ``dataset[i]`` samples and moves each batch
    to ``device``.  ``dataset`` needs ``len`` and integer indexing.  (The JAX
    package's threaded prefetch comes with training.)"""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for i in range(0, len(order), batch_size):
        chunk = order[i:i + batch_size]
        if drop_last and len(chunk) < batch_size:
            continue
        samples = [dataset[int(j)] for j in chunk]
        yield tuple(torch.stack([s[k] for s in samples]).to(device) for k in range(5))
