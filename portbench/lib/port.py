"""The system under test: the port's configuration, model and dataset, built
from a configuration file and a traffic file.

This is the only module of the harness besides the drivers that imports the
port (``fluid_llm_tpu_torch``).  The model's backbone takes every size from
the configuration file (the port's preset of the same name is overridden
field by field); its weights come from ``inputs/weights.py``, loaded by
name.  The dataset is the port's ``PatchDataset``: it locates, resamples,
normalises and patchifies the trajectories of ``inputs/cylinder.py``.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from fluid_llm_tpu_torch.config import Config
from fluid_llm_tpu_torch.core.triangulation import get_mesh_interpolation
from fluid_llm_tpu_torch.data.pipeline import PatchDataset, TrajectorySource
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.ops import exact_attention, flash_attention, grid_gnn_fused

from portbench.inputs import cylinder, weights


def port_config(conf: dict, traffic: dict, seed: int) -> Config:
    """The port's ``Config`` as the file states it, with the traffic's batch."""
    raw = dict(conf["fluid_llm"])
    raw["batch_size"] = traffic["batch_size"]
    raw["seed"] = int(seed) % (2 ** 31)
    return Config.from_dict(raw)


def backbone_fields(conf: dict) -> dict:
    """BackboneConfig fields from the Hugging Face keys of the file."""
    bb = conf["backbone"]
    fam = conf["family_constants"]
    de = bb["word_embed_proj_dim"]
    return dict(
        family=bb["model_type"], n_layers=bb["num_hidden_layers"], d_model=bb["hidden_size"],
        n_heads=bb["num_attention_heads"], d_ff=bb["ffn_dim"],
        max_pos=bb["max_position_embeddings"],
        d_embed=None if de == bb["hidden_size"] else de,
        pre_ln=bb["do_layer_norm_before"], final_ln=bb["do_layer_norm_before"],
        act=bb["activation_function"], pos="learned", pos_offset=fam["position_offset"],
        ln_eps=fam["layer_norm_eps"], dropout=bb["dropout"])


def build_model(conf: dict, cfg: Config, ds_props, seed: int, device: torch.device) -> FluidLLM:
    """The port's model, made on ``device`` with the seed's weights."""
    with torch.device(device):
        model = FluidLLM.build(cfg, ds_props, **backbone_fields(conf))
    model.load_state_dict(weights.make(conf, seed, device), strict=True)
    return model


class BenchDataset(PatchDataset):
    """``PatchDataset`` over the trajectories of ``inputs/cylinder.py``.

    Window starts are drawn from the seed by the harness: ``draw_step``
    hands ``make_batches`` a ticket, and ``sample`` looks the start up and
    records which trajectory and start each ticket became, so that the
    reference can build the same rows (tickets are drawn batch by batch, in
    order, on the caller's thread)."""

    def __init__(self, conf: dict, traffic: dict, seed: int, split: str):
        fl = conf["fluid_llm"]
        data = traffic["data"]
        super().__init__(
            resolution=fl["resolution"], patch_size=fl["patch_size"], seq_len=traffic["seq_len"],
            seq_interval=fl["seq_interval"], mode=split, normalize=fl["normalize_ds"],
            means=data["means"], stds=data["stds"], max_steps=data["steps"],
            seed=int(seed) % (2 ** 63))
        self.seed, self.split = int(seed), split
        self.n = data["trajectories"]
        self.nodes = tuple(data["mesh_nodes"])
        self.steps = data["steps"]
        self.fixed_start = traffic.get("window_start")
        self._starts = np.random.default_rng([self.seed, 7])
        self.tickets: list[int] = []
        self.rows: dict[int, tuple[int, int]] = {}
        self._rows_lock = threading.Lock()

    def num_trajectories(self) -> int:
        return self.n

    def get_trajectory(self, idx: int) -> TrajectorySource:
        return self.cached_trajectory(idx, self._build)

    def _build(self, idx: int) -> TrajectorySource:
        pos, faces, states = cylinder.trajectory(self.seed, self.split, idx, self.nodes, self.steps)
        interp = get_mesh_interpolation(pos, faces, self.resolution)
        return TrajectorySource(vert_idx=interp.vert_idx, weights=interp.weights,
                                mask=interp.mask, node_states=states)

    def draw_step(self) -> int:
        if self.fixed_start is not None:
            return int(self.fixed_start)
        self.tickets.append(int(self._starts.integers(0, self.max_step_num + 1)))
        return len(self.tickets) - 1

    def sample(self, idx: int, step_num=None):
        if self.fixed_start is None:
            k = self.draw_step() if step_num is None else step_num
            step_num = self.tickets[k]
            with self._rows_lock:
                self.rows[k] = (int(idx), step_num)
        return super().sample(idx, step_num)


def rollout_props(ds: BenchDataset, cfg: Config):
    """The rollout model's geometry: the test set's grid, the training window."""
    return dataclasses.replace(ds.ds_props(), seq_len=cfg.autoreg_seq_len - 1)


# the port's kernel entry points whose launch counters the runs print
COUNTERS = {
    "exact_attention": exact_attention.causal_attention,
    "flash_attention_fwd": flash_attention.flash_forward,
    "flash_attention_dq": flash_attention.flash_dq,
    "flash_attention_dkv": flash_attention.flash_dkv,
    "grid_slot_attention": grid_gnn_fused.fused_slot_attention,
    "grid_slot_attention_bwd": grid_gnn_fused.slot_attention_bwd,
}


def launches() -> dict[str, int]:
    return {k: int(fn.launches) for k, fn in COUNTERS.items()}
