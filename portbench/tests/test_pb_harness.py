"""The harness: no card means no result, no JAX is loaded, and a new
configuration, traffic mix and per-layer metric are found from files alone."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench.lib import imports, spec
from portbench.tests import tiny

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent


def test_forbidden_compares_whole_top_level_names():
    assert imports.forbidden(["fluid_llm_tpu_torch", "fluid_llm_tpu_torch.ops", "jaxtyping"]) == []
    assert imports.forbidden(["fluid_llm_tpu.models", "jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax", "fluid_llm_tpu", "jax", "jaxlib"]


def loaded(code: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=REPO, capture_output=True, text=True, check=True)
    return eval(out.stdout.strip().splitlines()[-1])


def test_nothing_the_harness_imports_is_jax():
    code = ("import portbench.run, portbench.calibrate\n"
            "from portbench.lib import spec\n"
            "cell = spec.load_cell(spec.Path('.'), 'opt125m.train_b64')\n"
            "cell = spec.load_cell(spec.Path('.'), 'opt350m.rollout_b32')\n")
    mods = loaded(code)
    assert "fluid_llm_tpu_torch" in mods
    assert imports.forbidden(mods) == []


def test_the_reference_imports_nothing_of_the_port():
    mods = loaded("import portbench.reference.check, portbench.reference.model, "
                  "portbench.reference.data, portbench.inputs.weights")
    assert "fluid_llm_tpu_torch" not in mods and imports.forbidden(mods) == []


def test_no_card_no_result(monkeypatch):
    from portbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = run.parse(["--workload", "opt125m.train_b64", "--seed", "1", "--seconds", "1"])
    assert run.run_cell(args) == (2, None)


def test_no_card_exits_without_a_line():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the no-card exit is shown by test_no_card_no_result")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "opt125m.train_b64",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_port_no_result(tmp_path):
    """A folder with BENCHMARK.json and the benchmark's files alone."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "opt125m.train_b64",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_benchmark_file_names_every_piece():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(REPO, w["name"])
        assert set(cell.limits["limits"])
        assert {m["name"] for m in cell.per_layer} == set(cell.readers)
        for m in cell.per_layer:
            reader = cell.readers[m["name"]]
            assert (reader.LAYER, reader.MOVES, reader.SOURCE) == (m["layer"], m["moves"],
                                                                    m["source"])


def test_new_config_traffic_and_metric_from_files_alone(tmp_path):
    root = tiny.make_root(tmp_path)
    pb = root / "portbench"
    conf = json.loads((pb / "configs" / "tiny_pre.json").read_text())
    conf["name"] = "tiny_new"
    conf["backbone"]["num_hidden_layers"] = 1
    (pb / "configs" / "tiny_new.json").write_text(json.dumps(conf))
    traffic = json.loads((pb / "traffic" / "tiny_train.json").read_text())
    traffic["batch_size"] = 2
    (pb / "traffic" / "tiny_new_mix.json").write_text(json.dumps(traffic))
    (pb / "limits" / "tiny_new.tiny_new_mix.json").write_text(
        json.dumps({"limits": tiny.LIMITS["tiny_pre.train"]}))
    (pb / "metrics" / "steps_traced.train.py").write_text(
        'LAYER = "loops"\nMOVES = "train_samples_per_s"\nSOURCE = "program_counter"\n\n\n'
        "def read(ctx):\n    return float(ctx.run.traced_steps)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_new", "source": "test", "reduced": [], "why": "test",
                             "file": "portbench/configs/tiny_new.json"})
    bench["workloads"].append({"name": "tiny_new.tiny_new_mix", "config": "tiny_new",
                               "traffic": "tiny_new_mix", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "steps_traced.train", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "loops",
                               "moves": "train_samples_per_s"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("tiny_new.tiny_new_mix")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell(root, "tiny_new.tiny_new_mix")
    assert cell.config["backbone"]["num_hidden_layers"] == 1 and cell.traffic["batch_size"] == 2
    assert "steps_traced.train" in cell.readers
    code, result = tiny.run(root, "tiny_new.tiny_new_mix", 77, seconds=0.2, trace=1)
    assert code == 0 and result["correct"]
    assert result["metrics"]["steps_traced.train"]["value"] == traffic["trace_steps"]
