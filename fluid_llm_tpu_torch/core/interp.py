"""Mesh->grid resampling: one gather + FMA per field.

Counterpart of ``fluid_llm_tpu/core/interp.py``.  Uses the
:class:`~fluid_llm_tpu_torch.core.triangulation.MeshInterp` arrays; masked
(outside-mesh) pixels are zeroed, matching ``to_grid``'s ``data[mask] = 0``
(``mesh_utils.py:87-90``).
"""

from __future__ import annotations

import torch


def resample_to_grid(
    node_values: torch.Tensor,
    vert_idx: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
) -> torch.Tensor:
    """Resample per-node field(s) onto the uniform grid.

    node_values: (..., N_nodes); vert_idx: (H, W, 3) int; weights: (H, W, 3)
    float; mask: (H, W) bool, True outside the mesh.  Returns (..., H, W);
    masked pixels are exactly 0.
    """
    gathered = node_values[..., vert_idx.long()]  # (..., H, W, 3)
    out = (gathered * weights.to(node_values.dtype)).sum(-1)
    return torch.where(mask, torch.zeros((), dtype=out.dtype, device=out.device), out)
