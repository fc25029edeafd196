"""Synthetic cylinder-flow-like dataset for tests and benchmarks.

Counterpart of ``fluid_llm_tpu/data/synthetic.py``: the cylinder patch
dataset and the graph-format EAGLE variant of the graph baselines.  The reference
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
from fluid_llm_tpu_torch.data.eagle_mesh import (
    NODE_INPUT, NODE_NORMAL, NODE_OUTPUT, NODE_WALL, GraphSample, faces_to_edges, one_hot9)
from fluid_llm_tpu_torch.data.pipeline import PatchDataset, TrajectorySource
from fluid_llm_tpu_torch.tools.clusterize import constrained_kmeans


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


class SyntheticGraphDataset:
    """Graph-format synthetic trajectories for the EAGLE-baseline pipeline
    (``fluid_llm_tpu/data/synthetic.py:61-152``): ``EagleMGNDataset``'s
    sample structure (state = [Vx, Vy, P, P], one-hot node types,
    bidirectional edges) on the generated meshes and analytic flow of
    :class:`SyntheticCylinderDataset`.  Everything but the window start is
    computed once per trajectory and cached, with GraphViT's cluster table
    where ``n_cluster > 0``: ``constrained_kmeans(pos, n_cluster, seed=
    base_seed + item)`` (``tools/clusterize``), the same at every step of a
    window."""

    def __init__(
        self,
        n_trajectories: int = 4,
        mode: str = "train",
        window_length: int = 5,
        mesh_nodes: tuple[int, int] = (24, 10),
        max_steps: int = 200,
        n_cluster: int = 0,
        seed: int = 1234,
    ):
        self.n_trajectories = n_trajectories
        self.mode = mode
        self.window_length = window_length
        self.mesh_nodes = mesh_nodes
        self.max_steps = max_steps
        self.n_cluster = n_cluster
        self.base_seed = seed + {"train": 0, "valid": 10_000, "test": 20_000}[mode]
        self._rng = np.random.default_rng(seed)
        self._traj_cache: dict[int, tuple] = {}

    def __len__(self):
        return self.n_trajectories

    def _trajectory(self, item: int):
        """Mesh, the full analytic trajectory, edges, one-hot types and the
        cluster table (None without clusters)."""
        if item not in self._traj_cache:
            pos, faces = make_cylinder_mesh(self.base_seed + item, *self.mesh_nodes)
            states = np.ascontiguousarray(
                analytic_flow(pos, self.max_steps, self.base_seed + item), np.float32)
            node_type = np.full(len(pos), NODE_NORMAL, np.int64)
            node_type[pos[:, 0] <= pos[:, 0].min()] = NODE_INPUT
            node_type[pos[:, 0] >= pos[:, 0].max()] = NODE_OUTPUT
            node_type[(pos[:, 1] <= pos[:, 1].min()) | (pos[:, 1] >= pos[:, 1].max())] = NODE_WALL
            cl = (constrained_kmeans(pos, self.n_cluster, seed=self.base_seed + item)
                  if self.n_cluster > 0 else None)
            self._traj_cache[item] = (pos.astype(np.float32), faces, states,
                                      faces_to_edges(faces.astype(np.int64)), one_hot9(node_type),
                                      cl)
        return self._traj_cache[item]

    def __getitem__(self, item: int) -> GraphSample:
        pos, faces, states, edges, nt9, cl = self._trajectory(item)
        T = self.window_length
        t0 = 100 if self.mode != "train" else int(
            self._rng.integers(0, self.max_steps - T + 1)
        )
        t0 = min(t0, self.max_steps - T)
        window = states[t0:t0 + T].transpose(0, 2, 1)  # (T, N, 3)
        press = np.repeat(window[..., 2:], 2, axis=-1)
        state = np.concatenate([window[..., :2], press], axis=-1).astype(np.float32)
        return GraphSample(
            mesh_pos=np.repeat(pos[None], T, axis=0),
            edges=edges,
            state=state,
            node_type=np.repeat(nt9[None], T, axis=0),
            cluster=np.repeat(cl[None], T, axis=0) if cl is not None else None,
            faces=faces,
        )


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

    def num_trajectories(self) -> int:
        return self.n_trajectories

    def get_trajectory(self, idx: int) -> TrajectorySource:
        return self.cached_trajectory(idx, self._build)

    def _build(self, idx: int) -> TrajectorySource:
        pos, faces = make_cylinder_mesh(self.base_seed + idx, *self.mesh_nodes)
        interp = get_mesh_interpolation(pos, faces, self.resolution)
        states = analytic_flow(pos, self.max_steps, self.base_seed + idx)
        return TrajectorySource(
            vert_idx=interp.vert_idx,
            weights=interp.weights,
            mask=interp.mask,
            node_states=states,
        )
