"""The port's profiling, benchmarking and dataset tools on the CPU.

- ``tools/profiling.summarize_trace``: on a synthetic Chrome trace the
  device events (kernels, memcpy, memset) are summed exactly per category
  and per op, host events ignored, the categories printed largest first;
  on a real CPU trace of ``torch.profiler`` (no device events) it returns
  None, as the JAX ``summarize_xplane`` without a TPU plane; and
  ``baselines_cli --profile_dir`` on the CPU writes its trace and says so.
- ``tools/rollout_profile`` (``trace``, ``trace_stream``),
  ``tools/train_profile`` and ``tools/flash_bench`` run to the end on
  ``--device cpu`` at 2 layers, d 64 and resolution 64 (flash_bench at 12
  heads x 64, L 64 and 130): the plain twins on both sides, so no time
  here is a measurement.
- ``tools/ds_stats``: ``Welford`` and ``compute_dataset_stats`` against the
  JAX package's on the same synthetic trajectories (rtol 1e-12), and its
  CLI's lines equal to JAX's on MGN-format pickles.
- ``tools/convert_mgn`` and ``tools/dataset_io`` write the same bytes as
  the JAX package's on the inputs ``tests/test_tools.py`` builds.
"""

import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from fluid_llm_tpu.data.synthetic import SyntheticCylinderDataset as JSynthetic
from fluid_llm_tpu.tools import convert_mgn as jconvert
from fluid_llm_tpu.tools import dataset_io as jdio
from fluid_llm_tpu.tools import ds_stats as jds_stats
from fluid_llm_tpu_torch import baselines_cli
from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
from fluid_llm_tpu_torch.tools import convert_mgn, dataset_io, ds_stats, flash_bench
from fluid_llm_tpu_torch.tools import profiling, rollout_profile, train_profile

sys.path.insert(0, os.path.dirname(__file__))
from test_tools import encode_example, write_tfrecord  # noqa: E402
from test_torch_pickle_data import write_trajectories  # noqa: E402

torch.set_num_threads(2)

TINY = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, dropout=0.0)
CPU = torch.device("cpu")


def _chrome(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_category_names():
    assert profiling.category(
        "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
        "std::array<char*, 1> >(int, at::native::FillFunctor<float>, std::array<char*, 1>)"
    ) == "vectorized_elementwise_kernel"
    assert profiling.category("void (anonymous namespace)::softmax_warp_forward<float, 4>"
                              "(float*, float const*, int)") == "softmax_warp_forward"
    assert profiling.category("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
    assert profiling.category("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n") == \
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n"


def test_summarize_synthetic_trace(tmp_path, capsys):
    kern = "void ns::exact_attention_fwd_kernel<64>(float*, int)"
    events = [
        {"ph": "X", "cat": "kernel", "name": kern, "dur": 30.0, "ts": 0},
        {"ph": "X", "cat": "kernel", "name": kern, "dur": 12.5, "ts": 40},
        {"ph": "X", "cat": "kernel", "name": "void at::native::mul_kernel<float>(float*)",
         "dur": 4.0, "ts": 60},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "dur": 2.0,
         "ts": 70},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "dur": 1.5, "ts": 80},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "dur": 100.0, "ts": 0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "dur": 9.0, "ts": 1},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "ts": 2},
        {"ph": "M", "name": "process_name", "args": {"name": "python"}},
    ]
    (tmp_path / "old").mkdir()
    _chrome(tmp_path / "old" / "trace.json", [events[2]])
    os.utime(tmp_path / "old" / "trace.json", (1, 1))  # the newest trace is read
    _chrome(tmp_path / "trace.json", events)
    out = profiling.summarize_trace(str(tmp_path), divisor=2)
    assert out == pytest.approx({"exact_attention_fwd_kernel": 0.0425, "mul_kernel": 0.004,
                                 "Memcpy DtoH": 0.002, "Memset": 0.0015, "_total": 0.05},
                                abs=1e-12)
    text = capsys.readouterr().out.splitlines()
    assert text[0] == "device busy: 0.05 ms (0.025 ms/step)"
    cats = text[text.index("== categories ==") + 1:text.index("== top ops ==")]
    assert [c.split("%")[-1].strip() for c in cats] == [
        "exact_attention_fwd_kernel", "mul_kernel", "Memcpy DtoH", "Memset"]
    assert text[text.index("== top ops ==") + 1].endswith(kern)


def test_summarize_cpu_trace_is_none(tmp_path, capsys):
    from fluid_llm_tpu_torch.train.loop import _profiler

    with _profiler(str(tmp_path), CPU):
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert profiling.summarize_trace(str(tmp_path)) is None
    assert "no device events" in capsys.readouterr().out
    assert profiling.summarize_trace(str(tmp_path / "empty")) is None


def test_baselines_cli_profile_dir(tmp_path, capsys):
    """Train steps 2-3 of epoch 0 traced on the CPU: the trace written, its
    summary None (no device events)."""
    trace = tmp_path / "trace"
    baselines_cli.main(["--model", "mgn", "--device", "cpu", "--n_processor", "1",
                        "--horizon_eval", "2", "--resolution", "48", "--save_dir",
                        str(tmp_path), "--n_traj", "4", "--batch_size", "1", "--epoch", "1",
                        "--profile_dir", str(trace)])
    assert (trace / "trace.json").stat().st_size > 0
    assert "no device events" in capsys.readouterr().out


@pytest.mark.parametrize("streaming", [False, True], ids=["trace", "trace_stream"])
def test_rollout_profile_trace_on_cpu(tmp_path, streaming):
    over = dict(TINY, max_pos=4096) if streaming else TINY
    out = rollout_profile.trace(CPU, streaming=streaming, trace_dir=str(tmp_path),
                                resolution=64, steps=2, **over)
    assert out is None and (tmp_path / "trace.json").stat().st_size > 0


def test_train_profile_on_cpu(tmp_path):
    losses = train_profile.run_trace(str(tmp_path), CPU, resolution=64, batch_size=2, **TINY)
    assert len(losses) == 1 + train_profile.TRACED_STEPS
    assert all(np.isfinite(losses))
    assert profiling.summarize_trace(str(tmp_path), divisor=3) is None


def test_flash_bench_on_cpu(capsys):
    rows = flash_bench.main(["1", "64", "130", "--device", "cpu", "--reps", "1"])
    assert [r["L"] for r in rows] == [64, 130]
    for r in rows:  # the twins on both sides on the CPU
        assert r["rel_out"] == 0.0 and r["lse_err"] == 0.0 and r["rel_grad"] == 0.0
        assert all(r[k] > 0 for k in ("plain_fwd", "flash_fwd", "plain_fb", "flash_fb"))
    assert "plain fwd" in capsys.readouterr().out


def test_welford_matches_jax():
    rng = np.random.default_rng(0)
    mine, ref = ds_stats.Welford(), jds_stats.Welford()
    for _ in range(4):
        chunk = rng.normal(size=(3, 50)) * 2 + 1
        mine.update(chunk)
        ref.update(chunk)
    assert (mine.count, mine.mean, mine.std) == (ref.count, ref.mean, ref.std)


def test_dataset_stats_match_jax():
    kw = dict(n_trajectories=2, resolution=32, max_steps=40, normalize=False)
    got = ds_stats.compute_dataset_stats(SyntheticCylinderDataset(**kw), seq_stride=2)
    want = jds_stats.compute_dataset_stats(JSynthetic(**kw), seq_stride=2)
    assert set(got) == {0, 1, 2}
    for c in range(3):
        for k, v in want[c].items():
            assert got[c][k] == pytest.approx(v, rel=1e-12, abs=1e-15), (c, k)


def test_ds_stats_cli_matches_jax(tmp_path, capsys):
    write_trajectories(tmp_path / "train", 2, steps=30)
    argv = ["--load_dir", str(tmp_path / "train"), "--resolution", "64", "--n_samples", "2"]
    stats = ds_stats.main(argv)
    mine = capsys.readouterr().out
    jds_stats.main(argv)
    assert mine == capsys.readouterr().out and len(mine.splitlines()) == 3
    assert stats[2]["state_std"] > 0


def _tfrecord_inputs(tmp_path):
    """``tests/test_tools.py``'s round trip inputs: 2 records of one
    trajectory, static fields tiled, cells that fit int16."""
    rng = np.random.default_rng(1234)
    T, N, F = 4, 7, 5
    meta = {
        "trajectory_length": T,
        "field_names": ["velocity", "mesh_pos", "cells", "node_type", "pressure"],
        "features": {
            "velocity": {"dtype": "float32", "type": "dynamic", "shape": [T, N, 2]},
            "pressure": {"dtype": "float32", "type": "dynamic", "shape": [T, N, 1]},
            "mesh_pos": {"dtype": "float32", "type": "static", "shape": [1, N, 2]},
            "cells": {"dtype": "int32", "type": "static", "shape": [1, F, 3]},
            "node_type": {"dtype": "int32", "type": "static", "shape": [1, N, 1]},
        },
    }
    fields = dict(velocity=rng.normal(size=(T, N, 2)).astype(np.float32),
                  pressure=rng.normal(size=(T, N, 1)).astype(np.float32),
                  mesh_pos=rng.normal(size=(1, N, 2)).astype(np.float32),
                  cells=rng.integers(0, N, size=(1, F, 3)).astype(np.int32),
                  node_type=rng.integers(0, 7, size=(1, N, 1)).astype(np.int32))
    example = encode_example({k: [v.tobytes()] for k, v in fields.items()})
    ds_dir = tmp_path / "raw"
    ds_dir.mkdir()
    (ds_dir / "meta.json").write_text(json.dumps(meta))
    write_tfrecord(str(ds_dir / "train.tfrecord"), [example, example])
    return ds_dir, fields


def test_convert_mgn_writes_jax_bytes(tmp_path):
    ds_dir, fields = _tfrecord_inputs(tmp_path)
    rec = next(convert_mgn.iter_tfrecords(str(ds_dir / "train.tfrecord")))
    assert convert_mgn.parse_example(rec) == jconvert.parse_example(rec)
    assert convert_mgn.main(["--dataset_dir", str(ds_dir), "--out_dir",
                             str(tmp_path / "mine")]) is None
    assert jconvert.convert_split(str(ds_dir), "train", str(tmp_path / "jax")) == 2
    for name in ("save_0.pkl", "save_1.pkl"):
        assert (tmp_path / "mine" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    with open(tmp_path / "mine" / "save_0.pkl", "rb") as f:
        saved = pickle.load(f)
    assert saved["cells"].dtype == np.int16
    np.testing.assert_array_equal(saved["velocity"], fields["velocity"])
    assert convert_mgn.convert_split(str(ds_dir), "train", str(tmp_path / "one"), limit=1) == 1


def test_dataset_io_writes_jax_bytes(tmp_path):
    for side in ("mine", "jax"):
        (tmp_path / side / "sub").mkdir(parents=True)
        for name, obj in (("a.pkl", {"x": 1, "y": np.arange(5)}), ("sub/b.pkl", [1.5, "z"])):
            with open(tmp_path / side / name, "wb") as f:
                pickle.dump(obj, f)
        (tmp_path / side / "sub" / "bad.pkl").write_bytes(b"not a pickle")
    mine = dataset_io.compress_dir(str(tmp_path / "mine"))
    ref = jdio.compress_dir(str(tmp_path / "jax"))
    assert [os.path.relpath(p, tmp_path / "mine") for p in mine] == \
        [os.path.relpath(p, tmp_path / "jax") for p in ref]
    for a, b in zip(mine, ref):
        assert open(a, "rb").read() == open(b, "rb").read()
    bad = dataset_io.integrity_check(str(tmp_path / "mine"))
    assert [os.path.relpath(p, tmp_path / "mine") for p in bad] == \
        [os.path.relpath(p, tmp_path / "jax") for p in jdio.integrity_check(str(tmp_path / "jax"))]
    os.remove(tmp_path / "mine" / "a.pkl")
    back = dataset_io.decompress_file(str(tmp_path / "mine" / "a.pkl.xz"))
    assert open(back, "rb").read() == (tmp_path / "jax" / "a.pkl").read_bytes()
    dataset_io.main(["check", str(tmp_path / "mine")])
