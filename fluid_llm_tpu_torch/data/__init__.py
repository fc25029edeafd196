"""Datasets: factory mirroring ``get_data_loader`` (``src/utils_model.py:9-45``).

Counterpart of ``fluid_llm_tpu/data/__init__.py``; only the synthetic route
is ported so far (the cylinder/airfoil pickles and EAGLE come later).
"""

from __future__ import annotations

from fluid_llm_tpu_torch.config import Config
from fluid_llm_tpu_torch.data.ds_props import DSProps
from fluid_llm_tpu_torch.data.pipeline import PatchDataset, make_batches
from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset


def get_dataset(cfg: Config, mode: str = "train") -> PatchDataset:
    """``load_dir: synthetic`` or ``synthetic:<n_trajectories>`` (default 4)."""
    name = cfg.load_dir
    if not name.startswith("synthetic"):
        raise ValueError(f"dataset {name!r}: only synthetic[:<n>] is ported")
    seq_len = cfg.seq_len if cfg.seq_len is not None else cfg.autoreg_seq_len
    n_traj = int(name.split(":", 1)[1]) if ":" in name else 4
    return SyntheticCylinderDataset(
        n_trajectories=n_traj,
        resolution=cfg.resolution,
        patch_size=cfg.patch_size,
        seq_len=seq_len,
        seq_interval=cfg.seq_interval,
        mode=mode,
        normalize=cfg.normalize_ds,
        absolute_time=cfg.absolute_time_ids,
    )


__all__ = ["DSProps", "PatchDataset", "get_dataset", "make_batches"]
