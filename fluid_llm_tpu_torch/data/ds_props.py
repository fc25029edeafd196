"""Patch-grid geometry (mirrors ``src/dataloader/ds_props.py:5-25``).

A copy of ``fluid_llm_tpu/data/ds_props.py``: that package's ``data/__init__``
imports jax, so the port keeps its own.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DSProps:
    """Static geometry of the patched grid.

    ``seq_len`` here is the number of *model input steps* — the dataset window
    length minus one, matching ``src/utils_model.py:42-44``.
    """

    Nx_patch: int
    Ny_patch: int
    patch_size: tuple[int, int]
    seq_len: int
    channel: int = 3
    downscale: int = 1

    @property
    def input_tot_size(self) -> tuple[int, int]:
        return (self.Nx_patch * self.patch_size[0], self.Ny_patch * self.patch_size[1])

    @property
    def out_tot_size(self) -> tuple[int, int]:
        return (
            self.Nx_patch * self.patch_size[0] // self.downscale,
            self.Ny_patch * self.patch_size[1] // self.downscale,
        )

    @property
    def N_patch(self) -> int:
        return self.Nx_patch * self.Ny_patch

    @property
    def out_patch_size(self) -> tuple[int, int]:
        return (self.patch_size[0] // self.downscale, self.patch_size[1] // self.downscale)

    @property
    def patch_in_dim(self) -> int:
        return self.patch_size[0] * self.patch_size[1] * self.channel
