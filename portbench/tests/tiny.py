"""A benchmark at a size a CPU test can hold, laid out as the real one.

``make_root(tmp)`` writes ``BENCHMARK.json`` and a ``portbench/`` folder
under ``tmp``: the real drivers and metric readers copied, and tiny
configurations (every width cut, a 4-patch grid), traffic mixes and
limits.  ``run(root, cell, seed)`` runs a cell through ``run.run_cell`` on
the CPU, the card's look skipped.
"""

from __future__ import annotations

import argparse
import copy
import json
import shutil
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent.parent


def tiny_config(name: str, post_ln: bool, card: bool = False) -> dict:
    """Every width cut; ``card``: heads of 64 and the published decoder
    widths, which the kernels take."""
    conf = json.loads((BENCH / "configs" / "opt350m.json").read_text()) if post_ln else \
        json.loads((BENCH / "configs" / "opt125m.json").read_text())
    conf = copy.deepcopy(conf)
    conf["name"] = name
    d = 128 if card else 64
    conf["backbone"].update(hidden_size=d, ffn_dim=2 * d, num_attention_heads=2 if card else 4,
                            num_hidden_layers=2, max_position_embeddings=128,
                            word_embed_proj_dim=d // 2 if post_ln else d)
    fl = conf["fluid_llm"]
    fl["lora_config"]["r"] = 4
    fl["lora_config"]["lora_alpha"] = 16
    fl["encoder_params"]["hidden_dim"] = 32
    if not card:
        fl["decoder_params"].update(gnn_dim=4, gnn_hid_dim=6, mlp_hid_dim=32)
    fl["resolution"] = 64
    fl["patch_size"] = fl["stride"] = [8, 8]
    fl["autoreg_seq_len"] = 4
    fl["num_workers"] = 2
    return conf


def traffic(kind: str) -> dict:
    data = {"trajectories": 5, "steps": 60, "mesh_nodes": [20, 8],
            "means": [0.8, 0.0, 0.05], "stds": [0.275, 0.275, 0.275]}
    if kind == "train":
        return {"kind": "train", "batch_size": 4, "seq_len": 4, "mode": "autoreg", "data": data,
                "check_steps": 3, "pool_batches": 4, "trace_steps": 2,
                "reference_rows": 3}
    return {"kind": "rollout", "batch_size": 3, "seq_len": 8, "pred_steps": 6, "start_state": 1,
            "window_start": 10, "data": data, "check_trajectories": 2,
            "check_rollout_within": 2, "reference_rows": 4}


# limits at this size, set as the cells' are: above the largest reading of
# the program over 12 seeds (4 100 000 000-011), below the smallest of the
# control (12 seeds) or of half a batch (4 seeds), each of which has to fail
# one number of its cell
LIMITS = {"tiny_pre.train": {"loss_gap": 0.008, "grad_gap": 0.05, "grad_median_gap": 0.008,
                             "delta_gap": 0.04},
          "tiny_post.train": {"loss_gap": 0.01, "grad_gap": 0.12, "grad_median_gap": 0.012,
                              "delta_gap": 0.035},
          "tiny_pre.rollout": {"data_gap": 1e-4, "step_ratio": 3.0},
          "tiny_post.rollout": {"data_gap": 1e-4, "step_ratio": 3.0}}


def make_root(tmp: Path, card: bool = False) -> Path:
    root = Path(tmp)
    pb = root / "portbench"
    for sub in ("drivers", "metrics"):
        shutil.copytree(BENCH / sub, pb / sub, ignore=shutil.ignore_patterns("__pycache__"))
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    real = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    configs, workloads = [], []
    for conf_name, post in (("tiny_pre", False), ("tiny_post", True)):
        (pb / "configs" / f"{conf_name}.json").write_text(json.dumps(tiny_config(conf_name, post, card)))
        configs.append({"name": conf_name, "source": "test", "file": f"portbench/configs/{conf_name}.json",
                        "reduced": [], "why": "test"})
        for kind in ("train", "rollout"):
            cell = f"{conf_name}.{kind}"
            workloads.append({"name": cell, "config": conf_name, "traffic": f"tiny_{kind}",
                              "chips": 1, "why": "test"})
            (pb / "limits" / f"{cell}.json").write_text(json.dumps({"limits": LIMITS[cell]}))
    for kind in ("train", "rollout"):
        (pb / "traffic" / f"tiny_{kind}.json").write_text(json.dumps(traffic(kind)))
    tr = [w["name"] for w in workloads if w["traffic"] == "tiny_train"]
    ro = [w["name"] for w in workloads if w["traffic"] == "tiny_rollout"]
    bench = dict(real, configs=configs, workloads=workloads)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = tr if m["workloads"][0].endswith("train_b64") else ro
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root: Path, cell: str, seed: int, seconds: float = 0.5, trace: int = 0,
        device: torch.device = torch.device("cpu")):
    from portbench import run as runner

    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace)
    return runner.run_cell(args, root=root, device=device)
