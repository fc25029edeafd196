"""Shared dataset pipeline: window -> grid -> pad -> patch -> normalize.

Counterpart of ``fluid_llm_tpu/data/pipeline.py``; reproduces the sample
layout of ``MGNDataset.ds_get`` (``src/dataloader/simple_dataloader.py:72-102``).
Each sample is

    (input_states, next_state, diffs, bc_mask, position_ids)

with patch tensors ``(seq_len-1, N_patch, 3, px, py)`` and position ids
``(seq_len-1, N_patch, 3)``, as CPU tensors; batches move to the model's
device in :func:`make_batches`.  The airfoil protocol's switches (y flip,
outer patch ring trimmed, masked normalisation; ``data/airfoil.py``) are
class attributes of the dataset, read by :func:`window_to_patches` and the
patch-count probe.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from fluid_llm_tpu_torch.core.interp import resample_to_grid
from fluid_llm_tpu_torch.data.ds_props import DSProps
from fluid_llm_tpu_torch.ops.patching import num_patches

# batches staged ahead of the consumer by the threaded ``make_batches``: the
# reference's ``prefetch_factor`` (``src/utils_model.py:34-39``)
PREFETCH = 2


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
    flip_y: bool = False,
    trim: bool = False,
    masked_norm: bool = False,
):
    """(seq, 3, H, W) grid window -> reference sample tuple (without ids).

    grid_mask: (H, W) bool (True outside mesh).  Padding pixels get mask=1
    and state=0 (``simple_dataloader.py:137-152``); normalisation uses fixed
    per-dataset stats (``:193-216``), applied on the grid before the diffs.

    The airfoil protocol's options (``src/dataloader/airfoil_ds.py``):
    ``flip_y`` mirrors the y axis (``:80``); ``trim`` drops the outer ring of
    patches (``:133``); ``masked_norm`` normalises inside-mesh pixels only
    (``:216-244``), so masked and padded pixels stay exactly 0.
    """
    seq = grid_states.shape[0]
    px, py = patch
    states = torch.nn.functional.pad(grid_states, (*pad_y, *pad_x))
    mask = torch.nn.functional.pad(grid_mask, (*pad_y, *pad_x), value=True)
    if flip_y:
        states, mask = states.flip(-1), mask.flip(-1)
    if trim:
        states, mask = states[:, :, px:-px, py:-py], mask[px:-px, py:-py]
    H, W = states.shape[-2:]
    nx, ny = H // px, W // py

    normed = (states - means[None, :, None, None]) / stds[None, :, None, None]
    states = torch.where(mask[None, None], states, normed) if masked_norm else normed

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

    # the airfoil protocol's switches (see ``window_to_patches``)
    flip_y: bool = False
    trim_patches: bool = False
    masked_norm: bool = False

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
        self._cache: dict[int, Future] = {}  # trajectory idx -> its TrajectorySource
        self._cache_lock = threading.Lock()  # guards ``_cache``; held for no build

    def num_trajectories(self) -> int:
        raise NotImplementedError

    def get_trajectory(self, idx: int) -> TrajectorySource:
        raise NotImplementedError

    def cached_trajectory(self, idx: int, build: Callable[[int], TrajectorySource],
                          limit: Optional[int] = None) -> TrajectorySource:
        """``build(idx)``, once per trajectory while it stays cached; at most
        ``limit`` trajectories are kept (None: all), the oldest evicted
        first.  The lock covers only the lookup, the eviction and the insert:
        ``make_batches``' threads build different trajectories side by side,
        and a thread asking for one in construction waits for that build."""
        with self._cache_lock:
            fut = self._cache.get(idx)
            owner = fut is None
            if owner:
                if limit is not None and len(self._cache) >= limit:
                    self._cache.pop(next(iter(self._cache)))
                fut = self._cache[idx] = Future()
        if owner:
            try:
                fut.set_result(build(idx))
            except BaseException as e:
                with self._cache_lock:
                    if self._cache.get(idx) is fut:
                        del self._cache[idx]
                fut.set_exception(e)
        return fut.result()

    def _probe(self):
        if self._geom is None:
            src = self.get_trajectory(min(1, self.num_trajectories() - 1))
            h, w = src.mask.shape
            pad_x, pad_y = pad_amounts(h, w, self.patch_size)
            nx = num_patches(h + sum(pad_x), self.patch_size[0], self.patch_size[0])
            ny = num_patches(w + sum(pad_y), self.patch_size[1], self.patch_size[1])
            if self.trim_patches:  # the outer ring dropped (``airfoil_ds.py:54``)
                nx, ny = nx - 2, ny - 2
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

    def draw_step(self) -> int:
        """The first trajectory step of the next window: a draw from the
        dataset's generator in training, 100 for val/test."""
        if self.mode in ("valid", "test"):
            return 100
        return int(self._rng.integers(0, self.max_step_num + 1))

    def sample(self, idx: int, step_num: Optional[int] = None):
        if step_num is None:
            step_num = self.draw_step()
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
            flip_y=self.flip_y, trim=self.trim_patches, masked_norm=self.masked_norm,
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
    num_workers: int = 0,
) -> Iterator[tuple]:
    """Stacks ``dataset`` samples into batches and moves each to ``device``.

    ``dataset`` needs ``len`` and integer indexing.  ``num_workers > 0``:
    worker threads build the batches, ``PREFETCH`` of them in flight ahead of
    the consumer, as the JAX package's (the reference's
    ``DataLoader(num_workers=6, prefetch_factor=2)``,
    ``src/utils_model.py:34-39``, runs processes).  A :class:`PatchDataset`'s
    window starts are drawn on the calling thread, batch by batch in order
    (``draw_step``), so threaded batches equal serial ones bit for bit.
    """
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    chunks = [order[i:i + batch_size] for i in range(0, len(order), batch_size)
              if not (drop_last and len(order[i:i + batch_size]) < batch_size)]
    draw = getattr(dataset, "draw_step", None)

    def plan(chunk):
        """Each sample's (index, window start), drawn here, in order."""
        return [(int(j), draw() if draw is not None else None) for j in chunk]

    def build(items):
        samples = [dataset[j] if step is None else dataset.sample(j, step) for j, step in items]
        return tuple(torch.stack([s[k] for s in samples]) for k in range(5))

    if num_workers <= 0:
        for chunk in chunks:
            yield tuple(t.to(device) for t in build(plan(chunk)))
        return
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending = [pool.submit(build, plan(c)) for c in chunks[:PREFETCH]]
        rest = iter(chunks[PREFETCH:])
        while pending:
            batch = pending.pop(0).result()
            chunk = next(rest, None)
            if chunk is not None:
                pending.append(pool.submit(build, plan(chunk)))
            yield tuple(t.to(device) for t in batch)
