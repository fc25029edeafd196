"""Datasets: factory mirroring ``get_data_loader`` (``src/utils_model.py:9-45``).

Counterpart of ``fluid_llm_tpu/data/__init__.py``, routed as it is by
``load_dir``: ``airfoil`` or any path containing it (``data/airfoil.py``);
``cylinder``, any path containing it or starting ``./ds/MGN``
(``data/cylinder.py``, the DeepMind MeshGraphNets pickles); ``synthetic`` or
``synthetic:<n_trajectories>`` (generated trajectories, default 4).  A
pickle dataset reads ``<load_dir>/<mode>/*.pkl``.
"""

from __future__ import annotations

from fluid_llm_tpu_torch.config import Config
from fluid_llm_tpu_torch.data.ds_props import DSProps
from fluid_llm_tpu_torch.data.pipeline import PatchDataset, make_batches


def get_dataset(cfg: Config, mode: str = "train") -> PatchDataset:
    name = cfg.load_dir
    seq_len = cfg.seq_len if cfg.seq_len is not None else cfg.autoreg_seq_len
    common = dict(
        resolution=cfg.resolution,
        patch_size=cfg.patch_size,
        seq_len=seq_len,
        seq_interval=cfg.seq_interval,
        mode=mode,
        normalize=cfg.normalize_ds,
        absolute_time=cfg.absolute_time_ids,
    )
    # by substring, as the reference's eval loader (``inference.py:28-45``)
    if "airfoil" in name:
        from fluid_llm_tpu_torch.data.airfoil import AirfoilDataset

        load_dir = "./ds/MGN/airfoil_dataset" if name == "airfoil" else name
        return AirfoilDataset(load_dir=f"{load_dir}/{mode}", **common)
    if "cylinder" in name or name.startswith("./ds/MGN"):
        from fluid_llm_tpu_torch.data.cylinder import MGNDataset

        load_dir = "./ds/MGN/cylinder_dataset" if name == "cylinder" else name
        return MGNDataset(load_dir=f"{load_dir}/{mode}", **common)
    if name.startswith("synthetic"):
        from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset

        n_traj = int(name.split(":", 1)[1]) if ":" in name else 4
        return SyntheticCylinderDataset(n_trajectories=n_traj, **common)
    raise ValueError(f"Invalid dataset {name}")


__all__ = ["DSProps", "PatchDataset", "get_dataset", "make_batches"]
