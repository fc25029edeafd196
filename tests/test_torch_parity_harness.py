"""The port's parity harness dry run (``tools/parity_harness.py --synthetic``)
on the CPU: the JAX file's case, the port's model and rollout."""

import json

import torch

from fluid_llm_tpu_torch.tools.parity_harness import main

torch.set_num_threads(2)


def test_parity_harness_synthetic(tmp_path):
    out = tmp_path / "BASELINE_MEASURED.json"
    record = main([
        "--synthetic", "--pred_steps", "6",
        "--synthetic_layers", "2", "--synthetic_resolution", "64",
        "--out", str(out), "--device", "cpu",
    ])
    on_disk = json.loads(out.read_text())
    assert on_disk["synthetic"] is True
    ours = on_disk["ours"]
    assert ours["n_rmse_mean"] > 0 and ours["wall_s"] > 0 and ours["device"] == "cpu"
    assert len(ours["per_step_head"]) == 6
    # no reference checkout here: the section stays None and the top-level
    # rate key (bench.py's contract in the JAX package) stays absent
    assert on_disk["reference"] is None
    assert "rollout_steps_per_sec" not in on_disk
    assert record["ours"]["n_rmse_mean"] == ours["n_rmse_mean"]
