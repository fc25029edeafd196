"""Synthetic cylinder-flow trajectories on a triangle mesh, made from a seed.

The DeepMind MeshGraphNets ``cylinder_flow`` trajectories that FLUID-LLM
trains on are not in the repository, so every run makes trajectories of
the same structure: a jittered triangulation of the channel
[0, 1.6] x [0, 0.41] with a circular obstacle whose centre and radius vary
from trajectory to trajectory, and a smooth unsteady (Vx, Vy, P) field of
travelling waves sampled at the mesh nodes.  The channel's outline is
fixed, so every trajectory resamples onto the same pixel grid (238 x 60 at
resolution 238); the obstacle moves, so the masks differ.

Written for the benchmark (the port's own generator is not read), and
numpy only: the program and the reference get the same arrays.
"""

from __future__ import annotations

import numpy as np

LENGTH, HEIGHT = 1.6, 0.41
SPLITS = {"train": 0, "valid": 1, "test": 2}


def rng_of(seed: int, split: str, idx: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), SPLITS[split], int(idx), int(stream)])


def make_mesh(rng: np.random.Generator, nx: int, ny: int) -> tuple[np.ndarray, np.ndarray]:
    """(pos (N, 2) float64, faces (F, 3) int32): a structured grid of
    ``nx`` x ``ny`` nodes, jittered inside (the outline stays straight), cut
    into two triangles a cell, less the triangles whose centroid lies in the
    obstacle."""
    xs = np.linspace(0.0, LENGTH, nx)
    ys = np.linspace(0.0, HEIGHT, ny)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    jitter = rng.uniform(-0.3, 0.3, size=(nx, ny, 2)) * np.array([xs[1] - xs[0], ys[1] - ys[0]])
    jitter[[0, -1], :, 0] = 0.0
    jitter[:, [0, -1], 1] = 0.0
    pos = np.stack([gx + jitter[..., 0], gy + jitter[..., 1]], -1).reshape(-1, 2)
    i, j = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="ij")
    a = (i * ny + j).ravel()
    b, c, d = a + ny, a + ny + 1, a + 1
    faces = np.concatenate([np.stack([a, b, c], 1), np.stack([a, c, d], 1)]).astype(np.int32)
    centre = np.array([rng.uniform(0.2, 0.5), rng.uniform(0.14, 0.27)])
    radius = rng.uniform(0.04, 0.07)
    outside = np.linalg.norm(pos[faces].mean(1) - centre, axis=1) > radius
    return pos, faces[outside]


def make_flow(rng: np.random.Generator, pos: np.ndarray, n_steps: int) -> np.ndarray:
    """(n_steps, 3, N) float32 (Vx, Vy, P): travelling waves whose phases,
    wave numbers and frequencies are drawn per trajectory, at an inflow
    speed ``u`` drawn per trajectory too (as the MeshGraphNets cylinder
    trajectories differ in inflow velocity): velocities scale with ``u``,
    the pressure with ``u**2`` and the waves' frequencies with ``u``."""
    x, y = pos[:, 0][None], pos[:, 1][None]
    t = np.arange(n_steps, dtype=np.float64)[:, None] * 0.02
    ph = rng.uniform(0, 2 * np.pi, 3)
    kx, ky, w = rng.uniform(3.0, 5.0, 3), rng.uniform(5.0, 8.0, 3), rng.uniform(1.2, 2.2, 3)
    u = rng.uniform(0.4, 1.6)
    w = w * u
    vx = u * (0.8 + 0.3 * np.sin(kx[0] * x - w[0] * t + ph[0]) * np.cos(ky[0] * y))
    vy = u * 0.15 * np.sin(ky[1] * y - w[1] * t + ph[1]) * np.cos(kx[1] * x)
    p = u * u * (0.05 + 0.2 * np.cos(kx[2] * x + ky[2] * y - w[2] * t + ph[2]))
    return np.stack([vx, vy, p], axis=1).astype(np.float32)


def trajectory(seed: int, split: str, idx: int, nodes: tuple[int, int], n_steps: int):
    """(pos, faces, states) of trajectory ``idx`` of ``split``."""
    pos, faces = make_mesh(rng_of(seed, split, idx, 0), *nodes)
    return pos, faces, make_flow(rng_of(seed, split, idx, 1), pos, n_steps)
