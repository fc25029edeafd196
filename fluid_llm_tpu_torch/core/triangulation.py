"""Host-side mesh->grid precomputation: resampling as data, not control flow.

A copy of the numpy code in ``fluid_llm_tpu/core/triangulation.py``
(``grid_pos`` :34-54, ``_locate_numpy`` :97-131, ``get_mesh_interpolation``
:161-200); that module imports the jax package's utilities, so the port keeps
its own.  One difference: point location always uses the numpy locator.  The
JAX package prefers matplotlib's trifinder, which the card's machine may not
have; the two can differ only for pixels exactly on a triangle edge.

Linear interpolation inside a triangle is barycentric interpolation of its
three vertex values, so every per-step resample is
``gather(values, vert_idx) . weights`` (``core/interp.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np


@lru_cache(maxsize=8)
def grid_pos(x_min: float, x_max: float, y_min: float, y_max: float, grid_res: int):
    """Aspect-ratio-preserving uniform grid (``src/dataloader/mesh_utils.py:64-79``).

    The long axis gets ``grid_res`` points; the short axis is scaled by the
    aspect ratio (truncated to int).  Endpoints inclusive, float32.
    """
    long_axis = max(x_max - x_min, y_max - y_min)
    short_axis = min(x_max - x_min, y_max - y_min)
    ratio = short_axis / long_axis

    if x_max - x_min > y_max - y_min:
        x_points, y_points = grid_res, int(grid_res * ratio)
    else:
        y_points, x_points = grid_res, int(grid_res * ratio)

    gx = np.linspace(x_min, x_max, x_points, dtype=np.float64)
    gy = np.linspace(y_min, y_max, y_points, dtype=np.float64)
    grid_x = np.broadcast_to(gx[:, None], (x_points, y_points)).astype(np.float32)
    grid_y = np.broadcast_to(gy[None, :], (x_points, y_points)).astype(np.float32)
    return np.ascontiguousarray(grid_x), np.ascontiguousarray(grid_y)


def _locate_numpy(pos, faces, grid_x, grid_y, eps: float = 1e-10) -> np.ndarray:
    """Per-pixel containing-triangle index, -1 outside the mesh.

    Grid pixels are axis-sorted, so each triangle's bbox selects a small
    rectangle of candidate pixels; a barycentric sign test assigns them.
    """
    H, W = grid_x.shape
    gx = grid_x[:, 0].astype(np.float64)
    gy = grid_y[0, :].astype(np.float64)
    tri_index = np.full((H, W), -1, dtype=np.int32)

    p = pos.astype(np.float64)
    t0, t1, t2 = p[faces[:, 0]], p[faces[:, 1]], p[faces[:, 2]]
    for t in range(len(faces)):
        a, b, c = t0[t], t1[t], t2[t]
        i0 = np.searchsorted(gx, min(a[0], b[0], c[0]) - eps, side="left")
        i1 = np.searchsorted(gx, max(a[0], b[0], c[0]) + eps, side="right")
        j0 = np.searchsorted(gy, min(a[1], b[1], c[1]) - eps, side="left")
        j1 = np.searchsorted(gy, max(a[1], b[1], c[1]) + eps, side="right")
        if i0 >= i1 or j0 >= j1:
            continue
        px = gx[i0:i1][:, None]
        py = gy[j0:j1][None, :]
        d = (b[1] - c[1]) * (a[0] - c[0]) + (c[0] - b[0]) * (a[1] - c[1])
        if d == 0.0:
            continue
        w0 = ((b[1] - c[1]) * (px - c[0]) + (c[0] - b[0]) * (py - c[1])) / d
        w1 = ((c[1] - a[1]) * (px - c[0]) + (a[0] - c[0]) * (py - c[1])) / d
        w2 = 1.0 - w0 - w1
        tol = 1e-9
        inside = (w0 >= -tol) & (w1 >= -tol) & (w2 >= -tol)
        block = tri_index[i0:i1, j0:j1]
        block[inside & (block == -1)] = t
        tri_index[i0:i1, j0:j1] = block
    return tri_index


@dataclass(frozen=True)
class MeshInterp:
    """Precomputed resampling data for one (mesh, resolution) pair.

    vert_idx:  (H, W, 3) int32 vertex indices of the containing triangle
               (0 for masked pixels; their output is zeroed).
    weights:   (H, W, 3) float32 barycentric weights; 0 for masked pixels.
    mask:      (H, W) bool, True outside the mesh.
    grid_x/y:  (H, W) float32 grid coordinates.
    tri_index: (H, W) int32 containing triangle (-1 outside).
    """

    vert_idx: np.ndarray
    weights: np.ndarray
    mask: np.ndarray
    grid_x: np.ndarray
    grid_y: np.ndarray
    tri_index: np.ndarray

    @property
    def shape(self) -> tuple[int, int]:
        return self.mask.shape


def get_mesh_interpolation(pos: np.ndarray, faces: np.ndarray, grid_res: int = 238) -> MeshInterp:
    """All per-mesh resampling data (``mesh_utils.py:94-106``).

    ``pos``: (N_nodes, 2) float mesh node positions; ``faces``: (N_tri, 3) int.
    """
    pos = np.asarray(pos, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int32)
    x_min, y_min = np.min(pos, axis=0)
    x_max, y_max = np.max(pos, axis=0)
    grid_x, grid_y = grid_pos(float(x_min), float(x_max), float(y_min), float(y_max), grid_res)

    tri_index = _locate_numpy(pos, faces, grid_x, grid_y)
    mask = tri_index == -1
    safe_tri = np.where(mask, 0, tri_index)

    vert_idx = faces[safe_tri]  # (H, W, 3)
    a = pos[vert_idx[..., 0]]
    b = pos[vert_idx[..., 1]]
    c = pos[vert_idx[..., 2]]
    px = grid_x.astype(np.float64)
    py = grid_y.astype(np.float64)
    det = (b[..., 1] - c[..., 1]) * (a[..., 0] - c[..., 0]) + (c[..., 0] - b[..., 0]) * (
        a[..., 1] - c[..., 1]
    )
    det = np.where(det == 0.0, 1.0, det)
    w0 = ((b[..., 1] - c[..., 1]) * (px - c[..., 0]) + (c[..., 0] - b[..., 0]) * (py - c[..., 1])) / det
    w1 = ((c[..., 1] - a[..., 1]) * (px - c[..., 0]) + (a[..., 0] - c[..., 0]) * (py - c[..., 1])) / det
    w2 = 1.0 - w0 - w1
    weights = np.stack([w0, w1, w2], axis=-1)
    weights = np.where(mask[..., None], 0.0, weights).astype(np.float32)
    vert_idx = np.where(mask[..., None], 0, vert_idx).astype(np.int32)

    return MeshInterp(
        vert_idx=vert_idx,
        weights=weights,
        mask=mask,
        grid_x=grid_x,
        grid_y=grid_y,
        tri_index=tri_index,
    )
