"""Airfoil dataset: the cylinder protocol plus crop, y flip, trim and masked
normalisation.

Counterpart of ``fluid_llm_tpu/data/airfoil.py`` (``AirfoilDataset``,
``src/dataloader/airfoil_ds.py:23-257``):

- the mesh is cropped to x in (-0.5, 2), y in (-0.75, 0.75), nodes and
  faces re-indexed (``:158-187``);
- the grid images are mirrored in y (``:80``);
- the outer ring of patches is trimmed (``:133``; ``N_{x,y}_patch - 2``,
  ``:54``);
- normalisation is masked: only inside-mesh pixels are shifted and scaled
  (``:216-244``), with the exact airfoil constants;
- the files are listed in natural order (``:44``).
"""

from __future__ import annotations

import os
import re

import numpy as np

from fluid_llm_tpu_torch.data.cylinder import MGNDataset, load_pickle_states

# parity-critical constants (``airfoil_ds.py:228-233``)
AIRFOIL_MEANS = (170.1, -1.183, 9.935e4)
AIRFOIL_STDS = (50.0, 50.0, 6197.0)

CROP_X = (-0.5, 2.0)
CROP_Y = (-0.75, 0.75)


def crop_mesh(pos: np.ndarray, faces: np.ndarray, fields: list[np.ndarray]):
    """Remove the outer region and re-index faces (``airfoil_ds.py:164-183``).
    ``fields``: arrays (T, N, ...) of node values, cropped on axis 1."""
    keep = ((pos[:, 0] > CROP_X[0]) & (pos[:, 0] < CROP_X[1])
            & (pos[:, 1] > CROP_Y[0]) & (pos[:, 1] < CROP_Y[1]))
    new_index = np.zeros(len(keep), dtype=np.int64)
    new_index[keep] = np.arange(int(keep.sum()))
    face_keep = keep[faces].all(axis=1)
    new_faces = new_index[faces[face_keep]]
    return pos[keep], new_faces.astype(np.int32), [f[:, keep] for f in fields]


def natural_key(name: str) -> list:
    """Sort key of natsort's default order: digit runs compared as numbers."""
    return [int(c) if c.isdigit() else c for c in re.split(r"(\d+)", name)]


class AirfoilDataset(MGNDataset):
    MEANS, STDS = AIRFOIL_MEANS, AIRFOIL_STDS
    flip_y = True
    trim_patches = True
    masked_norm = True

    @staticmethod
    def list_files(load_dir: str) -> list[str]:
        return sorted((f for f in os.listdir(load_dir) if f.endswith(".pkl")), key=natural_key)

    def mesh_and_states(self, idx: int):
        pos, faces, vel, press = load_pickle_states(
            os.path.join(self.load_dir, self.save_files[idx]))
        pos, faces, (vel, press) = crop_mesh(pos, faces.astype(np.int64), [vel, press])
        return pos, faces, np.concatenate([vel, press], axis=-1).transpose(0, 2, 1)
