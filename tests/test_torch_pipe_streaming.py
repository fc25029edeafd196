"""The port's streaming decode over pipeline stages on the CPU, against the
JAX package's one-device streaming and the port's one process.

Ranks are CPU processes over gloo (``tests/torch_mesh_worker.py``): one
spawn of four ranks runs the streaming rollout on pipe 2 (data 2 x pipe 2)
and on pipe 2 x model 2, one of two ranks ``python -m
fluid_llm_tpu_torch.inference --distributed --streaming`` on a pipe-2
config.

- The model is the LLaMA / rope_abs one of ``tests/test_torch_streaming.py``
  (d 64, 4 heads) at 4 layers, full fine-tuning (pipeline parallelism
  takes no adapters), its weights the JAX init's.  4 streamed steps from
  one state of 2 trajectories: each pipe rank holds and caches its stage's
  2 blocks, at 2 heads a rank under model 2.  Held to JAX's one-device
  ``gen_seq_streaming`` (the JAX package runs streaming on a pipe mesh
  through GSPMD, equal to one device) and to the port's one process at the
  tolerance of the tensor-parallel streaming test
  (``tests/test_torch_sharded_serving.py``), atol 2e-5, rtol 1e-5.
- The entry point: ``fluid/llama-125m`` at full width cut to 2 layers,
  seeded weights, 3 steps on pipe 2: the per-step N-RMSE within 1e-5 of
  one process's run.
- The daemon: ``python -m fluid_llm_tpu_torch.tools.serve --distributed
  --quant int8`` on 2 ranks of a pipe-2 checkpoint of that model (each rank
  quantizes and streams its stage's block): a 3-step reply within 1e-4 of
  the one-process int8 engine's (``tests/test_torch_serve.py``'s bound).
"""

import csv
import os
import sys

import jax
import numpy as np
import pytest
import torch

from fluid_llm_tpu.config import Config as JConfig
from fluid_llm_tpu.data.pipeline import make_batches as jmake_batches
from fluid_llm_tpu.data.synthetic import SyntheticCylinderDataset as JSynthetic
from fluid_llm_tpu.models.fluid_llm import FluidLLM as JFluidLLM
from fluid_llm_tpu.rollout.streaming import gen_seq_streaming as jgen_seq_streaming
from fluid_llm_tpu_torch.config import Config
from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.rollout.streaming import gen_seq_streaming
from fluid_llm_tpu_torch.tools import serve as srv
from fluid_llm_tpu_torch.train import checkpoint as ckpt
from fluid_llm_tpu_torch.weights import from_jax_params

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_sharded_serving import STREAM, STREAM_TINY, _body, _free_port  # noqa: E402
from torch_mesh_worker import spawn  # noqa: E402

torch.set_num_threads(2)

SEQ_LEN = 5
STEPS = 4
FULL_FT = dict(STREAM, use_lora=False)
TINY = dict(STREAM_TINY, n_layers=4)
MESHES = [("pipe 2", {"pipe_axis": 2}, {"data": 2, "fsdp": 1, "model": 1, "pipe": 2}, 4),
          ("pipe 2 x model 2", {"pipe_axis": 2, "model_axis": 2},
           {"data": 1, "fsdp": 1, "model": 2, "pipe": 2}, 2)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe_streaming")
    args = dict(n_trajectories=2, resolution=64, seq_len=SEQ_LEN, mode="valid",
                absolute_time=True)
    jds, tds = JSynthetic(**args), SyntheticCylinderDataset(**args)
    jm = JFluidLLM.build(JConfig(**FULL_FT), jds.ds_props(), **TINY)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    batch = tuple(map(torch.as_tensor, next(jmake_batches(jds, 2, shuffle=False))))
    state = from_jax_params(params)
    variants = [dict(parallel=par, prepare=None, stream=STEPS) for _, par, _, _ in MESHES]
    res = spawn("forward", 4, str(tmp / "run"), variants=variants, cfg=FULL_FT, tiny=TINY,
                state=state, batch=batch)
    one = FluidLLM.build(Config(**FULL_FT), tds.ds_props(), **TINY)
    one.load_state_dict(state)
    one.eval().prepare_inference_params()
    with torch.no_grad():
        want_one = gen_seq_streaming(one, batch, STEPS)[0]
    want_jax = jax.jit(lambda p, b: jgen_seq_streaming(jm, p, b, STEPS)[0])(
        params, tuple(np.asarray(t) for t in batch))
    return dict(res=res, one=want_one.numpy(), jax=np.asarray(want_jax))


@pytest.mark.parametrize("i", range(len(MESHES)), ids=[m[0] for m in MESHES])
def test_streaming_over_pipe_stages(world, i):
    name, _, mesh, heads = MESHES[i]
    got = world["res"][i]
    assert got["mesh"] == mesh and got["heads"] == heads, name
    # every rank holds its stage's 2 blocks and caches those only
    assert all(n_blocks == 2 and cache_layers == 2 for _, n_blocks, cache_layers in got["blocks"])
    out = got["out"].numpy()
    assert out.shape == world["one"].shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, world["one"], atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(out, world["jax"], atol=2e-5, rtol=1e-5)


def test_one_process_matches_jax(world):
    """The reference the meshes are held to, against JAX's."""
    np.testing.assert_allclose(world["one"], world["jax"], atol=2e-5, rtol=1e-5)


def test_inference_entry_streams_over_pipe_stages(tmp_path):
    """``inference --distributed --streaming`` on 2 ranks of a pipe-2
    config: the per-step N-RMSE of one process's run within 1e-5."""
    from fluid_llm_tpu_torch import inference

    cfg = Config(**{**FULL_FT, "llm_layers": 2, "load_dir": "synthetic:1",
                    "parallel": {"pipe_axis": 2}})
    path = str(tmp_path / "pipe.yaml")
    cfg.to_yaml(path)
    argv = ["--config_path", path, "--streaming", "--seq_len", "5", "--pred_steps", "3"]
    spawn("entry", 2, str(tmp_path / "ranks"), entry="inference",
          argv=argv + ["--csv", str(tmp_path / "mesh.csv")])
    inference.main(argv + ["--device", "cpu", "--csv", str(tmp_path / "one.csv")])
    read = lambda p: [float(r["n_rmse"]) for r in csv.DictReader(open(p))]
    got, want = read(tmp_path / "mesh.csv"), read(tmp_path / "one.csv")
    assert len(got) == len(want) == 3
    assert got == pytest.approx(want, rel=1e-5)


def test_daemon_over_pipe_stages(tmp_path):
    """``tools.serve --distributed --quant int8`` on 2 ranks of a pipe-2
    checkpoint: ``/v1/info`` reports the mesh, a 3-step streamed reply
    equal to the one-process int8 engine's within 1e-4."""
    from fluid_llm_tpu_torch.core.interp import resample_to_grid
    from fluid_llm_tpu_torch.data import get_dataset

    cfg = Config(**{**FULL_FT, "llm_layers": 2, "parallel": {"pipe_axis": 2}})
    props = SyntheticCylinderDataset(n_trajectories=1, resolution=64, seq_len=SEQ_LEN,
                                     absolute_time=True).ds_props()
    model = FluidLLM.build(cfg, props)
    model.init_weights(torch.Generator().manual_seed(0))
    runs = str(tmp_path / "runs")
    ckpt.save_checkpoint(ckpt.make_save_folder(runs), 1, model,
                         torch.optim.SGD(model.parameters(), lr=0.0), 0, cfg)
    src = get_dataset(cfg.replace(seq_len=4), mode="test").get_trajectory(0)
    grid = resample_to_grid(torch.from_numpy(src.node_states[:1]), torch.from_numpy(src.vert_idx),
                            torch.from_numpy(src.weights), torch.from_numpy(src.mask)).numpy()
    mask = np.asarray(src.mask, np.uint8)
    want = srv.load_engine(runs, buckets=(3,), quant="int8", device="cpu").predict(grid, mask, 3)
    res = spawn("serve", 2, str(tmp_path / "ranks"), port=_free_port(), fail_at=0,
                requests=[_body(grid, mask, 3)],
                argv=["--checkpoint_dir", runs, "--buckets", "3", "--quant", "int8"])
    (_, _, info), reply = res
    assert info["mesh"] == {"data": 1, "fsdp": 1, "model": 1, "pipe": 2} and info["ranks"] == 2
    assert info["streaming"] is True and reply[1] == 200, reply[:2]
    out = srv._unb64(reply[2]["states"], reply[2]["shape"], np.float32)
    np.testing.assert_allclose(out, want, atol=1e-4, rtol=0)
