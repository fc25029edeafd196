"""Synthetic cylinder-flow-like dataset for tests and benchmarks.

Counterpart of ``fluid_llm_tpu/data/synthetic.py`` (cylinder part; the
graph-format EAGLE variant comes with the graph baselines).  The reference
expects the DeepMind MeshGraphNets ``cylinder_flow`` pickles on disk, which
are not vendored; this generates trajectories of the same structure -- an
irregular triangular mesh with a circular obstacle and a smooth unsteady
(Vx, Vy, P) field -- deterministically from a seed.  ``make_cylinder_mesh``
and ``analytic_flow`` are copies of the numpy originals, so both packages
see the same meshes and fields.
"""

from __future__ import annotations

import numpy as np

from fluid_llm_tpu_torch.core.triangulation import get_mesh_interpolation
from fluid_llm_tpu_torch.data.pipeline import PatchDataset, TrajectorySource


def make_cylinder_mesh(seed: int, nx: int = 40, ny: int = 16):
    """Jittered structured triangulation over [0,1.6]x[0,0.41] minus a disc."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(0.0, 1.6, nx)
    ys = np.linspace(0.0, 0.41, ny)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    jit = rng.uniform(-0.3, 0.3, size=(nx, ny, 2)) * np.array([xs[1] - xs[0], ys[1] - ys[0]])
    jit[0, :, 0] = jit[-1, :, 0] = 0.0
    jit[:, 0, 1] = jit[:, -1, 1] = 0.0
    pos = np.stack([X + jit[..., 0], Y + jit[..., 1]], axis=-1).reshape(-1, 2)

    faces = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            a = i * ny + j
            b = (i + 1) * ny + j
            c = (i + 1) * ny + j + 1
            d = i * ny + j + 1
            faces.append([a, b, c])
            faces.append([a, c, d])
    faces = np.asarray(faces, np.int32)

    # carve a cylindrical hole: drop triangles whose centroid is inside
    center, radius = np.array([0.3, 0.2]), 0.06
    centroids = pos[faces].mean(axis=1)
    keep = np.linalg.norm(centroids - center, axis=1) > radius
    return pos.astype(np.float64), faces[keep]


def analytic_flow(pos: np.ndarray, n_steps: int, seed: int) -> np.ndarray:
    """Smooth unsteady field (n_steps, 3, N_nodes): travelling vortices."""
    rng = np.random.default_rng(seed + 77)
    x, y = pos[:, 0], pos[:, 1]
    t = np.arange(n_steps)[:, None] * 0.02
    ph = rng.uniform(0, 2 * np.pi, 3)
    vx = 0.8 + 0.3 * np.sin(4.0 * x[None] - 1.3 * t + ph[0]) * np.cos(7.0 * y[None])
    vy = 0.15 * np.sin(6.0 * y[None] - 1.7 * t + ph[1]) * np.cos(3.0 * x[None])
    p = 0.05 + 0.2 * np.cos(3.0 * x[None] + 5.0 * y[None] - 2.1 * t + ph[2])
    return np.stack([vx, vy, p], axis=1).astype(np.float32)  # (T, 3, N)


class SyntheticCylinderDataset(PatchDataset):
    """Drop-in stand-in for ``MGNDataset`` backed by generated trajectories."""

    def __init__(
        self,
        n_trajectories: int = 4,
        resolution: int = 64,
        patch_size: tuple[int, int] = (16, 16),
        seq_len: int = 10,
        seq_interval: int = 1,
        mode: str = "train",
        normalize: bool = True,
        max_steps: int = 600,
        mesh_nodes: tuple[int, int] = (40, 16),
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
            # stats in the spirit of the fixed cylinder constants
            # (``simple_dataloader.py:205-210``)
            means=(0.8, 0.0, 0.05),
            stds=(0.275, 0.275, 0.275),
            max_steps=max_steps,
            seed=seed,
            absolute_time=absolute_time,
        )
        self.n_trajectories = n_trajectories
        self.mesh_nodes = mesh_nodes
        self.max_steps = max_steps
        # distinct trajectories per split (train/valid/test don't overlap)
        self.base_seed = seed + {"train": 0, "valid": 10_000, "test": 20_000}[mode]
        self._cache: dict[int, TrajectorySource] = {}

    def num_trajectories(self) -> int:
        return self.n_trajectories

    def get_trajectory(self, idx: int) -> TrajectorySource:
        if idx not in self._cache:
            pos, faces = make_cylinder_mesh(self.base_seed + idx, *self.mesh_nodes)
            interp = get_mesh_interpolation(pos, faces, self.resolution)
            states = analytic_flow(pos, self.max_steps, self.base_seed + idx)
            self._cache[idx] = TrajectorySource(
                vert_idx=interp.vert_idx,
                weights=interp.weights,
                mask=interp.mask,
                node_states=states,
            )
        return self._cache[idx]
