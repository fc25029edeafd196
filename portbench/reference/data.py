"""The reference's data layer: mesh -> pixel grid -> patches, in NumPy.

FLUID-LLM's dataloader (``src/dataloader/simple_dataloader.py``,
``mesh_utils.py``): each pixel of an aspect-preserving float32 grid over
the mesh's bounding box is located in a triangle and takes the barycentric
blend of its three nodes' values (pixels outside the mesh are 0 and
masked); the grid is padded, centred, to whole patches (padding masked);
states are normalised by the dataset's fixed means and stds; a window of
``seq_len`` frames gives ``seq_len - 1`` inputs, their successors and
their differences, as patches of ``(3, px, py)``, patch index
``xb * Ny + yb``.  Position ids label patch ``a`` of a frame
``(a % Nx, (a // Nx) % Ny)`` (the reference's x-fastest labelling) and
the frame's index in the window.

``dtype`` is float32 for the reference and bfloat16 for its control: the
blend and the normalisation are then rounded to bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.inputs import cylinder
from portbench.inputs.weights import geometry, grid_shape


def locate(pos: np.ndarray, faces: np.ndarray, gx: np.ndarray, gy: np.ndarray):
    """(triangle index (H, W), -1 outside; barycentric weights (H, W, 3)).

    Each triangle tests the pixels of its bounding box (all triangles at
    once, the boxes padded to the largest): a sign test of the barycentric
    coordinates in float64 with a tolerance of 1e-9.  A pixel on an edge
    keeps the triangle of lowest index that holds it."""
    H, W = gx.shape
    xs, ys = gx[:, 0].astype(np.float64), gy[0, :].astype(np.float64)
    p = pos.astype(np.float64)
    a, b, c = p[faces[:, 0]], p[faces[:, 1]], p[faces[:, 2]]
    lo, hi = np.minimum(np.minimum(a, b), c), np.maximum(np.maximum(a, b), c)
    i0 = np.searchsorted(xs, lo[:, 0] - 1e-10)
    i1 = np.searchsorted(xs, hi[:, 0] + 1e-10, "right")
    j0 = np.searchsorted(ys, lo[:, 1] - 1e-10)
    j1 = np.searchsorted(ys, hi[:, 1] + 1e-10, "right")
    di, dj = int(max((i1 - i0).max(), 1)), int(max((j1 - j0).max(), 1))
    ii = i0[:, None, None] + np.arange(di)[None, :, None]  # (T, di, 1)
    jj = j0[:, None, None] + np.arange(dj)[None, None, :]  # (T, 1, dj)
    inbox = (ii < i1[:, None, None]) & (jj < j1[:, None, None])
    ii, jj = np.minimum(ii, H - 1), np.minimum(jj, W - 1)
    px, py = xs[ii], ys[jj]
    ax, ay, bx, by, cx, cy = (v[:, None, None] for v in (a[:, 0], a[:, 1], b[:, 0], b[:, 1],
                                                         c[:, 0], c[:, 1]))
    det = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
    safe = np.where(det == 0.0, 1.0, det)
    w0 = ((by - cy) * (px - cx) + (cx - bx) * (py - cy)) / safe
    w1 = ((cy - ay) * (px - cx) + (ax - cx) * (py - cy)) / safe
    w2 = 1.0 - w0 - w1
    hit = inbox & (det != 0.0) & (w0 >= -1e-9) & (w1 >= -1e-9) & (w2 >= -1e-9)
    t_idx = np.broadcast_to(np.arange(len(faces))[:, None, None], hit.shape)[hit]
    flat = (np.broadcast_to(ii, hit.shape) * W + np.broadcast_to(jj, hit.shape))[hit]
    order = np.lexsort((t_idx, flat))  # by pixel, then triangle
    flat, t_idx = flat[order], t_idx[order]
    first = np.ones(len(flat), bool)
    first[1:] = flat[1:] != flat[:-1]
    tri = np.full(H * W, -1, np.int64)
    tri[flat[first]] = t_idx[first]
    wts = np.stack([w0, w1, w2], -1)[hit][order][first]
    bary = np.zeros((H * W, 3))
    bary[flat[first]] = wts
    return tri.reshape(H, W), bary.reshape(H, W, 3)


def grid(pos: np.ndarray, resolution: int) -> tuple[np.ndarray, np.ndarray]:
    lo, hi = pos.min(0), pos.max(0)
    nx, ny = grid_shape(resolution)
    if hi[1] - lo[1] > hi[0] - lo[0]:
        raise ValueError("the channel's long axis is x")
    gx = np.linspace(lo[0], hi[0], nx, dtype=np.float64).astype(np.float32)
    gy = np.linspace(lo[1], hi[1], ny, dtype=np.float64).astype(np.float32)
    return (np.broadcast_to(gx[:, None], (nx, ny)).copy(),
            np.broadcast_to(gy[None, :], (nx, ny)).copy())


class Data:
    """Trajectories of one split, resampled on demand and cached."""

    def __init__(self, conf: dict, traffic: dict, seed: int, split: str,
                 dtype: torch.dtype = torch.float32):
        self.conf, self.traffic, self.seed, self.split = conf, traffic, int(seed), split
        self.geo = geometry(conf)
        self.dtype = dtype
        self._cache: dict[int, tuple] = {}

    def _trajectory(self, idx: int):
        if idx not in self._cache:
            d = self.traffic["data"]
            pos, faces, states = cylinder.trajectory(self.seed, self.split, idx,
                                                     tuple(d["mesh_nodes"]), d["steps"])
            gx, gy = grid(pos, self.conf["fluid_llm"]["resolution"])
            tri, bary = locate(pos, faces, gx, gy)
            mask = tri < 0
            verts = faces[np.where(mask, 0, tri)]  # (H, W, 3)
            self._cache[idx] = (states, verts, np.where(mask[..., None], 0.0, bary), mask)
        return self._cache[idx]

    def frames(self, idx: int, start: int, n: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(normalised padded frames (n, 3, H, W), mask (H, W)) of steps
        ``start .. start + n - 1``."""
        states, verts, bary, mask = self._trajectory(idx)
        vals = torch.from_numpy(states[start:start + n])  # (n, 3, N)
        v = vals[..., torch.from_numpy(verts).long()]  # (n, 3, H, W, 3)
        w = torch.from_numpy(bary)
        if self.dtype == torch.float32:
            img = (v.double() * w.double()).sum(-1).float()
        else:
            img = (v.to(self.dtype) * w.to(self.dtype)).sum(-1)
        m = torch.from_numpy(mask)
        img = torch.where(m, torch.zeros((), dtype=img.dtype), img)
        g = self.geo
        img = torch.nn.functional.pad(img, (*g["pad_y"], *g["pad_x"]))
        m = torch.nn.functional.pad(m, (*g["pad_y"], *g["pad_x"]), value=True)
        d = self.traffic["data"]
        mean = torch.tensor(d["means"], dtype=img.dtype)[:, None, None]
        std = torch.tensor(d["stds"], dtype=img.dtype)[:, None, None]
        return ((img - mean) / std).float(), m

    def window(self, idx: int, start: int, n: int) -> dict:
        """A window of ``n`` frames as images: inputs (n-1, 3, H, W), their
        successors, the mask (H, W), and the position ids (n-1, N, 3)."""
        img, m = self.frames(idx, start, n)
        g = self.geo
        a = torch.arange((n - 1) * g["n_patch"])
        pos = torch.stack([a % g["nx"], (a // g["nx"]) % g["ny"], a // g["n_patch"]], 1)
        return dict(inputs=img[:-1], targets=img[1:], mask=m,
                    pos=pos.reshape(n - 1, g["n_patch"], 3))


def to_patches(img: torch.Tensor, geo: dict) -> torch.Tensor:
    """(..., C, H, W) -> (..., N, C, px, py), patch ``xb * Ny + yb``."""
    px, py = geo["patch"]
    nx, ny = geo["nx"], geo["ny"]
    lead, c = img.shape[:-3], img.shape[-3]
    x = img.reshape(*lead, c, nx, px, ny, py)
    k = len(lead)
    x = x.permute(*range(k), k + 1, k + 3, k, k + 2, k + 4)
    return x.reshape(*lead, nx * ny, c, px, py)

