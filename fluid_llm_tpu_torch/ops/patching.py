"""Patch <-> image algebra as pure reshape/permute.

Counterpart of ``fluid_llm_tpu/ops/patching.py``.  With non-overlapping
patches (patch_size == stride, the only supported configuration) the
reference's ``F.unfold``/``F.fold`` (``src/utils_model.py:77-109``) is a
static reshape and permute.

Layout contract (matches ``F.unfold``, so position ids line up):

- image axes are ``(..., C, X, Y)`` where X is the long/flow axis,
- patch index ``p = xb * Ny_patch + yb`` (y-block fastest),
- within a patch, pixel ``(i, j)`` maps to image ``(xb*px + i, yb*py + j)``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

if TYPE_CHECKING:
    from fluid_llm_tpu_torch.data.ds_props import DSProps


def img_to_patch(img: torch.Tensor, ds_props: "DSProps") -> torch.Tensor:
    """``(..., C, tot_px, tot_py) -> (..., N_patch, C, px, py)``."""
    px, py = ds_props.patch_size
    nx, ny = ds_props.Nx_patch, ds_props.Ny_patch
    lead = img.shape[:-3]
    c = img.shape[-3]
    x = img.reshape(*lead, c, nx, px, ny, py)
    n = len(lead)
    # (..., C, nx, px, ny, py) -> (..., nx, ny, C, px, py)
    x = torch.movedim(x, (n, n + 1, n + 3), (n + 2, n, n + 1))
    return x.reshape(*lead, nx * ny, c, px, py)


def patch_to_img(patches: torch.Tensor, ds_props: "DSProps") -> torch.Tensor:
    """``(..., N_patch, C, px, py) -> (..., C, tot_px, tot_py)``."""
    px, py = ds_props.patch_size
    nx, ny = ds_props.Nx_patch, ds_props.Ny_patch
    lead = patches.shape[:-4]
    c = patches.shape[-3]
    x = patches.reshape(*lead, nx, ny, c, px, py)
    n = len(lead)
    # (..., nx, ny, C, px, py) -> (..., C, nx, px, ny, py)
    x = torch.movedim(x, (n, n + 1, n + 2), (n + 1, n + 3, n))
    return x.reshape(*lead, c, nx * px, ny * py)


def fold_features(tokens: torch.Tensor, ds_props: "DSProps", feat_dim: int) -> torch.Tensor:
    """Scatter per-patch feature vectors onto the pixel grid (the decoder's
    ``F.fold``, ``src/models/layers/GNN/decoders.py:229-235``).

    ``(..., N_patch, px*py*feat) -> (..., tot_px, tot_py, feat)``; each patch
    vector unflattens as (feat, px, py).
    """
    opx, opy = ds_props.out_patch_size
    nx, ny = ds_props.Nx_patch, ds_props.Ny_patch
    lead = tokens.shape[:-2]
    x = tokens.reshape(*lead, nx, ny, feat_dim, opx, opy)
    n = len(lead)
    # (..., nx, ny, feat, px, py) -> (..., nx, px, ny, py, feat)
    x = torch.movedim(x, (n + 2, n + 3, n + 4), (n + 4, n + 1, n + 3))
    return x.reshape(*lead, nx * opx, ny * opy, feat_dim)


def num_patches(dim_size: int, kern_size: int, stride: int, padding: int = 0) -> int:
    """``src/dataloader/simple_dataloader.py:16-20``."""
    return (dim_size + 2 * padding - kern_size) // stride + 1
