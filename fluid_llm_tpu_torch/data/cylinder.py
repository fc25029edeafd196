"""Cylinder-flow dataset over DeepMind MeshGraphNets pickles.

Counterpart of ``fluid_llm_tpu/data/cylinder.py`` (``MGNDataset``,
``src/dataloader/simple_dataloader.py:23-229``): each ``.pkl`` holds
``{'cells', 'mesh_pos', 'velocity', 'pressure', ...}`` (the format of
``max/ds_download/MGN_unload.py:84-99``).  The interpolation constants are
built once per trajectory and cached (at most ``MAX_CACHE`` trajectories);
normalisation uses the exact cylinder constants
(``simple_dataloader.py:205-210``).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from fluid_llm_tpu_torch.core.triangulation import get_mesh_interpolation
from fluid_llm_tpu_torch.data.pipeline import PatchDataset, TrajectorySource

# parity-critical constants (``simple_dataloader.py:205-210``)
CYLINDER_MEANS = (0.823, 0.0005865, 0.04763)
CYLINDER_STDS = (0.275, 0.275, 0.275)
MAX_CACHE = 8  # trajectories whose interpolation is kept


def load_pickle_states(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One trajectory pickle -> (mesh_pos f64 (N, 2), cells (F, 3), velocity
    f32 (T, N, 2), pressure f32 (T, N, 1))."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    return (np.asarray(data["mesh_pos"], np.float64), np.asarray(data["cells"]),
            np.asarray(data["velocity"], np.float32), np.asarray(data["pressure"], np.float32))


class MGNDataset(PatchDataset):
    MEANS, STDS = CYLINDER_MEANS, CYLINDER_STDS  # the dataset's fixed statistics

    def __init__(
        self,
        load_dir: str,
        resolution: int = 238,
        patch_size: tuple[int, int] = (16, 16),
        seq_len: int = 10,
        seq_interval: int = 1,
        mode: str = "train",
        normalize: bool = True,
        seed: int = 1234,
        absolute_time: bool = False,
    ):
        super().__init__(
            resolution=resolution,
            patch_size=patch_size,
            seq_len=seq_len,
            seq_interval=seq_interval,
            mode=mode,
            normalize=normalize,
            means=self.MEANS,
            stds=self.STDS,
            max_steps=600,  # ``simple_dataloader.py:40``
            seed=seed,
            absolute_time=absolute_time,
        )
        self.load_dir = load_dir
        self.save_files = self.list_files(load_dir)
        if not self.save_files:
            raise FileNotFoundError(f"No .pkl trajectories in {load_dir}")

    @staticmethod
    def list_files(load_dir: str) -> list[str]:
        return sorted(f for f in os.listdir(load_dir) if f.endswith(".pkl"))

    def num_trajectories(self) -> int:
        return len(self.save_files)

    def mesh_and_states(self, idx: int):
        """(pos, faces, (T, 3, N) node states) of trajectory ``idx``."""
        pos, faces, vel, press = load_pickle_states(
            os.path.join(self.load_dir, self.save_files[idx]))
        return pos, faces, np.concatenate([vel, press], axis=-1).transpose(0, 2, 1)

    def get_trajectory(self, idx: int) -> TrajectorySource:
        return self.cached_trajectory(idx, self._build, MAX_CACHE)

    def _build(self, idx: int) -> TrajectorySource:
        pos, faces, states = self.mesh_and_states(idx)
        interp = get_mesh_interpolation(pos, faces, self.resolution)
        return TrajectorySource(
            vert_idx=interp.vert_idx,
            weights=interp.weights,
            mask=interp.mask,
            node_states=np.ascontiguousarray(states),
        )
