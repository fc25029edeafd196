"""Graph-model N-RMSE: interpolate node states to the grid, then N-RMSE.

Counterpart of ``fluid_llm_tpu/train/eagle_eval.py`` (``eagle/eagle_utils.py:
60-130``, ``get_nrmse``): predicted and true node states are resampled onto
the uniform grid through the linear triangulation interpolation of the main
pipeline (``core/triangulation``, ``core/interp``), masked, and scored with
``calc_n_rmse``, on the device the states are on.
"""

from __future__ import annotations

import numpy as np
import torch

from fluid_llm_tpu_torch.core.interp import resample_to_grid
from fluid_llm_tpu_torch.core.triangulation import get_mesh_interpolation
from fluid_llm_tpu_torch.train.metrics import calc_n_rmse


def get_nrmse(true_states, pred_states, mesh_pos: np.ndarray, faces: np.ndarray,
              resolution: int = 238) -> np.ndarray:
    """true/pred: (bs, seq, N_nodes, C >= 3) tensors or arrays; mesh_pos:
    (N_nodes, 2); faces: (F, 3).  Uses channels [:3] = (Vx, Vy, P) as the
    reference.  Returns the per-(batch, step) N-RMSE."""
    true_states, pred_states = (torch.as_tensor(s) for s in (true_states, pred_states))
    dev = true_states.device
    interp = get_mesh_interpolation(np.asarray(mesh_pos), np.asarray(faces), resolution)
    geometry = [torch.from_numpy(a).to(dev) for a in (interp.vert_idx, interp.weights, interp.mask)]

    def to_imgs(states):  # (bs, seq, N, C) -> (bs, seq, 3, H, W)
        return resample_to_grid(states[..., :3].transpose(-1, -2), *geometry)

    true_imgs, pred_imgs = to_imgs(true_states), to_imgs(pred_states.to(dev))
    mask = geometry[2][None, None, None].expand(1, true_imgs.shape[1], 3, *interp.shape)
    return calc_n_rmse(pred_imgs, true_imgs, mask).cpu().numpy()
