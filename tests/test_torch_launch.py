"""The entry points over several processes, on the CPU.

``main --distributed`` with ``--coordinator_address`` (a ``file://`` init
URL, so no ports), ``--num_processes 2`` and ``--process_id`` trains
``tests/test_torch_parallel.py``'s configuration (GPT-2 cut to 2 layers at
its own width) with ``parallel.model_axis: 2``
on ``synthetic:2`` for one epoch (rank 0 logs and writes the checkpoint);
``continue_train`` resumes it in one process; ``inference --distributed``
rolls out from it on 2 ranks (heads over the model axis).  Each against the
same entry point in one process: the logged losses and N-RMSE within 1e-5
relative, the per-step N-RMSE of the rollout within 1e-5 relative.
Without ``--distributed`` no process group starts.
"""

import argparse
import csv
import json
import os
import sys

import pytest
import torch
import torch.distributed as dist
import yaml

from fluid_llm_tpu_torch import continue_train, inference
from fluid_llm_tpu_torch import main as tmain
from fluid_llm_tpu_torch.parallel import launch
from fluid_llm_tpu_torch.train import checkpoint as ckpt

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_parallel import CFG  # noqa: E402
from torch_mesh_worker import spawn  # noqa: E402

torch.set_num_threads(2)

TINY_YAML = dict(CFG, llm_layers=2, load_dir="synthetic:2", num_epochs=1, save_model_each=1,
                 val_seq_len=4, parallel={"model_axis": 2})


def _jsonl(path) -> list:
    return [json.loads(line) for line in open(path)]


def _csv(path) -> list:
    with open(path) as f:
        return [float(r["n_rmse"]) for r in csv.DictReader(f)]


def test_main_distributed_continue_inference(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    mesh_runs, one_runs = str(tmp_path / "mesh"), str(tmp_path / "one")
    argv = lambda runs, jl: ["--config_path", _cfg(tmp_path, runs), "--metrics_jsonl", jl]
    mesh_jl, one_jl = str(tmp_path / "mesh.jsonl"), str(tmp_path / "one.jsonl")
    spawn("entry", 2, str(tmp_path / "train"), entry="main", argv=argv(mesh_runs, mesh_jl))
    assert tmain.main(argv(one_runs, one_jl) + ["--device", "cpu"]) == 1
    got, want = _jsonl(mesh_jl), _jsonl(one_jl)
    assert [m["epoch"] for m in got] == [0]
    for k, v in want[0].items():
        assert got[0][k] == pytest.approx(v, rel=1e-5), k

    # the mesh run's checkpoint resumes in one process
    run = ckpt.get_save_folder(mesh_runs, -1)
    saved = yaml.safe_load(open(os.path.join(run, "config.yaml")))
    with open(os.path.join(run, "config.yaml"), "w") as f:
        yaml.safe_dump(dict(saved, num_epochs=1), f)
    # (the run re-enters the loop at the saved epoch, as the JAX package's)
    assert continue_train.main(["--checkpoint_dir", mesh_runs, "--device", "cpu",
                                "--metrics_jsonl", mesh_jl]) == 1
    logs = _jsonl(mesh_jl)
    assert [m["epoch"] for m in logs] == [0, 0] and logs[1]["train/Autoreg/loss"] > 0

    # and rolls out on 2 ranks as in one process
    roll = ["--checkpoint_dir", mesh_runs, "--seq_len", "4", "--pred_steps", "2"]
    spawn("entry", 2, str(tmp_path / "roll"), entry="inference",
          argv=roll + ["--csv", str(tmp_path / "mesh.csv")])
    inference.main(roll + ["--device", "cpu", "--csv", str(tmp_path / "one.csv")])
    got, want = _csv(tmp_path / "mesh.csv"), _csv(tmp_path / "one.csv")
    assert len(got) == len(want) == 2
    assert got == pytest.approx(want, rel=1e-5)


def _cfg(tmp_path, runs: str) -> str:
    """GPT-2's layout cut to 2 layers (12 heads: 6 a rank), checkpoints
    under ``runs``."""
    path = tmp_path / f"{os.path.basename(runs)}.yaml"
    path.write_text(yaml.safe_dump(dict(TINY_YAML, checkpoint_save_path=runs)))
    return str(path)


def test_no_process_group_without_distributed(monkeypatch):
    """Without ``--distributed`` the entry points start no process group,
    and the multi-process flags alone are refused."""
    def boom(*a, **k):
        raise AssertionError("init_process_group called")

    monkeypatch.setattr(dist, "init_process_group", boom)
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cpu")
    launch.add_arguments(parser)
    assert launch.init(parser.parse_args([]), parser) == torch.device("cpu")
    assert not dist.is_initialized() and launch.is_lead() and launch.share(3) == 3
    with pytest.raises(SystemExit):
        launch.init(parser.parse_args(["--process_id", "0"]), parser)
    with pytest.raises(SystemExit):  # the three flags go together
        launch.init(parser.parse_args(["--distributed", "--process_id", "0"]), parser)
