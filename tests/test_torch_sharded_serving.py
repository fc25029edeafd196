"""The port's sharded serving on the CPU, against the JAX package's.

Ranks are CPU processes over gloo (``tests/torch_mesh_worker.py``): one
spawn of four ranks (data 2 x model 2) runs the streaming rollout and the
quantized storage, one of two ranks (model 2) the serving daemon through
``python -m fluid_llm_tpu_torch.tools.serve --distributed``.

- Streaming (``tests/test_streaming.py:296-324``): the LLaMA / rope_abs
  model of ``tests/test_torch_streaming.py`` (2 layers, d 64, 4 heads, DoRA
  r 4 on q, v and o with ``B`` made non-zero, merged when prepared), 4
  steps from one state on data 2 x model 2 (2 heads a rank), held to the
  port's one-process rollout and to JAX's on its data 2 x model 4 mesh
  (the JAX test's), atol 2e-5, rtol 1e-5.
- Quantized storage on model 2: GPT-2 at d 256 (every rank-local linear
  one the w8a16 kernel takes), int8 or nf4; each rank's storage equal bit
  for bit to JAX's sharded storage of the same weights (the row-parallel o
  and fc2's scales from the whole K, equal on both model ranks), and the
  served forward within 1e-5 of JAX's on its mesh; with DoRA on q, v and
  o merged first (o's column norms summed over the axis), the int8
  forward within 1e-5 of JAX's merged and quantized model.
- The daemon over 2 ranks (``fluid/llama-125m`` at full width cut to 1
  layer, DoRA, int8, streamed, 6 heads a rank): an HTTP round trip equal
  to the one-process engine's within 1e-4 (``tests/test_torch_serve.py``'s
  rollout bound); a follower whose batch does not reach its device gives a
  500 and the next request the same answer as the first; the interrupt's
  stop ends every rank; a follower that fails inside the rollout gives a
  500 within ``--collective_timeout``, and then every rank exits.
"""

import json
import os
import socket
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_llm_tpu.config import Config as JConfig
from fluid_llm_tpu.config import ParallelConfig as JParallel
from fluid_llm_tpu.data.pipeline import make_batches as jmake_batches
from fluid_llm_tpu.data.synthetic import SyntheticCylinderDataset as JSynthetic
from fluid_llm_tpu.models.fluid_llm import FluidLLM as JFluidLLM
from fluid_llm_tpu.models.lora import merge_lora as jmerge_lora
from fluid_llm_tpu.ops.quant import quantize_backbone as jquantize_backbone
from fluid_llm_tpu.parallel import mesh as jmesh
from fluid_llm_tpu.rollout.streaming import gen_seq_streaming as jgen_seq_streaming
from fluid_llm_tpu_torch.config import Config
from fluid_llm_tpu_torch.core.interp import resample_to_grid
from fluid_llm_tpu_torch.data import get_dataset
from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.rollout.streaming import gen_seq_streaming
from fluid_llm_tpu_torch.tools import serve as srv
from fluid_llm_tpu_torch.train import checkpoint as ckpt
from fluid_llm_tpu_torch.weights import from_jax_params

sys.path.insert(0, os.path.dirname(__file__))
from torch_mesh_worker import spawn  # noqa: E402

torch.set_num_threads(2)

SEQ_LEN = 5
LORA = {"r": 4, "lora_alpha": 16, "use_dora": True, "lora_dropout": 0.0,
        "target_modules": ("q_proj", "v_proj", "o_proj")}
STREAM = dict(
    llm_backbone="fluid/llama-125m", half_precision=False, use_lora=True, batch_size=2,
    autoreg_seq_len=SEQ_LEN, seq_len=SEQ_LEN, resolution=64, flash_attention=False,
    absolute_time_ids=True, lora_config=LORA,
    pos_embedding_params={"pos_embedding_type": "rope_abs", "input_emb_layer_dropout": 0.0},
    decoder_params={"type": "MLPGNN", "gnn_dim": 8, "gnn_hid_dim": 12, "gnn_layers": 2,
                    "gnn_heads": 1, "mlp_hid_dim": 32, "dropout": 0.0},
    encoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32,
                    "activation": "leakyrelu"},
)
STREAM_TINY = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, max_pos=4096, dropout=0.0)
QUANT = dict(
    llm_backbone="gpt2", half_precision=False, use_lora=True, batch_size=2, autoreg_seq_len=4,
    seq_len=4, resolution=64, flash_attention=False, lora_config=LORA,
    pos_embedding_params={"input_emb_layer_dropout": 0.0},
    decoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32, "activation": "leakyrelu",
                    "zero_last_layer": False, "dropout": 0.0},
    encoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32,
                    "activation": "leakyrelu"},
)
QUANT_TINY = dict(n_layers=2, d_model=256, n_heads=4, d_ff=512, max_pos=128, dropout=0.0)
STEPS = 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _datasets(seq_len: int, **kw):
    args = dict(n_trajectories=2, resolution=64, seq_len=seq_len, mode="valid", **kw)
    return JSynthetic(**args), SyntheticCylinderDataset(**args)


def jax_params(cfg_kw: dict, tiny: dict, jds) -> tuple:
    """The JAX model and its init, the adapters' ``B`` made non-zero."""
    jm = JFluidLLM.build(JConfig(**cfg_kw), jds.ds_props(), **tiny)
    params = _np(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    for layer in params["lora"]["layers"]:
        for leaf in layer["attn"].values():
            leaf["B"] = rng.normal(size=leaf["B"].shape).astype(np.float32) * 0.05
    return jm, params


def _one_process(cfg_kw: dict, tiny: dict, tds, state: dict) -> FluidLLM:
    model = FluidLLM.build(Config(**cfg_kw), tds.ds_props(), **tiny)
    model.load_state_dict(state)
    return model.eval()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One four-rank spawn on data 2 x model 2: the streaming rollout, then
    int8 and nf4 serving storage and forwards."""
    tmp = tmp_path_factory.mktemp("sharded_serving")
    sj, st = _datasets(SEQ_LEN, absolute_time=True)
    qj, qt = _datasets(4)
    s_model, s_params = jax_params(STREAM, STREAM_TINY, sj)
    q_model, q_params = jax_params(QUANT, QUANT_TINY, qj)
    s_batch = tuple(map(torch.as_tensor, next(jmake_batches(sj, 2, shuffle=False))))
    q_batch = tuple(torch.as_tensor(np.concatenate([np.asarray(x)] * 2, axis=0))
                    for x in next(jmake_batches(qj, 2, shuffle=False)))
    par = {"model_axis": 2}
    stream = dict(parallel=par, cfg=STREAM, tiny=STREAM_TINY, batch=s_batch,
                  state=from_jax_params(s_params), prepare=None, stream=STEPS)
    full = dict(QUANT, use_lora=False)  # no merge: the same float weights on both sides
    quant = [dict(parallel=par, prepare=q, cfg=full) for q in ("int8", "nf4")]
    quant.append(dict(parallel=par, prepare="int8"))  # DoRA on q, v, o merged first
    res = spawn("forward", 4, str(tmp / "run"), variants=[stream] + quant, cfg=QUANT,
                tiny=QUANT_TINY, state=from_jax_params(q_params), batch=q_batch)
    return dict(res=res, sj=sj, st=st, qj=qj, qt=qt, s_model=s_model, s_params=s_params,
                q_model=q_model, q_params=q_params, s_batch=s_batch, q_batch=q_batch)


def test_streaming_on_tensor_parallel_mesh(world):
    """4 streamed steps on data 2 x model 2 (2 heads a rank, the slab cache
    at the rank's kv columns): equal to one process's and to JAX's sharded
    streaming (``tests/test_streaming.py:296-324``'s tolerances)."""
    got = world["res"][0]
    assert got["mesh"] == {"data": 2, "fsdp": 1, "model": 2} and got["heads"] == 2
    one = _one_process(STREAM, STREAM_TINY, world["st"], from_jax_params(world["s_params"]))
    one.prepare_inference_params()
    with torch.no_grad():
        want_one = gen_seq_streaming(one, world["s_batch"], STEPS)[0]
    np.testing.assert_allclose(got["out"].numpy(), want_one.numpy(), atol=2e-5, rtol=1e-5)
    jpar = JParallel(data_axis=2, fsdp_axis=1, model_axis=4)
    mesh = jmesh.make_mesh(jpar)
    params = jmesh.shard_params(jax.tree_util.tree_map(jnp.asarray, world["s_params"]), mesh,
                                JParallel(fsdp_axis=1, model_axis=4))
    batch = jmesh.shard_batch(tuple(np.asarray(t) for t in world["s_batch"]), mesh)
    want = jax.jit(lambda p, b: jgen_seq_streaming(world["s_model"], p, b, STEPS)[0])(params,
                                                                                     batch)
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


def _jax_quantized(world, mode: str, merge: bool = False):
    """JAX's serving transform (``tools/serve.py:442-456``): the adapters
    merged (``merge``; else dropped: a full fine-tune's weights), the
    backbone quantized whole, then placed on data 4 x model 2."""
    p = world["q_params"]
    backbone = p["backbone"]
    if merge:
        backbone = jmerge_lora(backbone, p["lora"], JConfig(**QUANT).lora_config)
    backbone = jquantize_backbone(backbone, mode)
    params = {k: v for k, v in p.items() if k != "lora"}
    params["backbone"] = backbone
    jpar = JParallel(model_axis=2)
    mesh = jmesh.make_mesh(jpar)
    return jmesh.shard_params(jax.tree_util.tree_map(jnp.asarray, params), mesh, jpar), mesh


def _jax_shard(arr, mesh, model_index: int) -> np.ndarray:
    """The shard of ``arr`` on the device at data 0, model ``model_index``."""
    dev = mesh.devices[0, 0, model_index]
    return next(np.asarray(s.data) for s in arr.addressable_shards if s.device == dev)


@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_quantized_storage_on_model_axis(world, mode):
    """Cut over model 2, then quantized whole and cut again: each rank's int8
    ``q`` and ``scale`` (or nf4 leaves) equal bit for bit to JAX's shard of
    the same weights on the same model index, row-parallel scales included;
    the forward within 1e-5 of JAX's on its mesh."""
    got = world["res"][1 + ("int8", "nf4").index(mode)]
    jparams, mesh = _jax_quantized(world, mode)
    leaves = ("q", "scale") if mode == "int8" else \
        ("codes", "absmax_q", "absmax_scale", "absmax_offset")
    seen = set()
    for coords, storage in got["held"]:
        for name, t in storage.items():
            parts = name.split(".")
            assert parts[:2] == ["backbone", "layers"], name
            _, _, li, group, lin, leaf = parts
            assert leaf in leaves, name
            want = _jax_shard(jparams["backbone"]["layers"][int(li)][group][lin]["w"][leaf],
                              mesh, coords["model"])
            if leaf == "q":
                want = want.T  # JAX (in, out), the port (out, in)
            assert np.array_equal(t.numpy(), want), (coords, name)
            seen.add((lin, leaf))
    want_seen = {(lin, leaf) for lin in ("q", "k", "v", "o", "fc1", "fc2") for leaf in leaves}
    assert seen == want_seen
    if mode == "int8":  # the row-parallel scales: whole, equal on both model ranks
        scales = [s["backbone.layers.0.attn.o.scale"] for _, s in got["held"]]
        assert scales[0].shape == (256,) and all(torch.equal(s, scales[0]) for s in scales)
    states, _, _, _, pos = (np.asarray(t) for t in world["q_batch"])
    want = jax.jit(world["q_model"].forward)(jparams, *jmesh.shard_batch((states, pos), mesh))
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _body(grid: np.ndarray, mask: np.ndarray, pred_steps: int) -> dict:
    return {"states": srv._b64(grid.astype(np.float32)), "shape": list(grid.shape),
            "mask": srv._b64(mask), "pred_steps": pred_steps}


def _daemon_checkpoint(tmp_path) -> tuple[str, np.ndarray, np.ndarray]:
    """A run folder of the LLaMA layout on model 2 (1 layer, non-zero DoRA
    adapters) and a one-frame request's grid and mask."""
    cfg = Config(**{**STREAM, "llm_layers": 1, "parallel": {"model_axis": 2}})
    _, tds = _datasets(SEQ_LEN, absolute_time=True)
    model = FluidLLM.build(cfg, tds.ds_props())
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():  # non-zero adapters: merging matters
        for p in model.lora.parameters():
            p.add_(0.01)
    runs = str(tmp_path / "runs")
    run = ckpt.make_save_folder(runs)
    ckpt.save_checkpoint(run, 1, model, torch.optim.SGD(model.parameters(), lr=0.0), 0, cfg)
    # the serving dataset of a 3-step bucket (``serve.load_engine``'s)
    src = get_dataset(cfg.replace(seq_len=4), mode="test").get_trajectory(0)
    grid = resample_to_grid(torch.from_numpy(src.node_states[:1]), torch.from_numpy(src.vert_idx),
                            torch.from_numpy(src.weights), torch.from_numpy(src.mask)).numpy()
    return runs, grid, np.asarray(src.mask, np.uint8)


def test_daemon_over_two_ranks(tmp_path):
    """``python -m fluid_llm_tpu_torch.tools.serve --distributed --quant
    int8`` on 2 ranks (the checkpoint's model 2: the LLaMA layout streamed,
    6 heads a rank): ``/v1/info`` reports the mesh; a 3-step request equals
    the one-process engine's; a follower whose batch does not reach its
    device makes the next request a 500, and the one after answers as the
    first; stop ends both ranks."""
    runs, grid, mask = _daemon_checkpoint(tmp_path)
    one = srv.load_engine(runs, buckets=(3,), quant="int8", device="cpu")
    want = one.predict(grid, mask, 3)
    body = _body(grid, mask, 3)
    # the follower's third batch (warmup, then the first request) fails
    res = spawn("serve", 2, str(tmp_path / "ranks"), port=_free_port(), fail_at=3,
                requests=[body, body, body],
                argv=["--checkpoint_dir", runs, "--buckets", "3", "--quant", "int8"])
    (_, _, info), first, failed, again = res
    assert info["mesh"] == {"data": 1, "fsdp": 1, "model": 2} and info["ranks"] == 2
    assert info["streaming"] is True
    assert first[1] == 200 and again[1] == 200, (first[1], again[1])
    out = srv._unb64(first[2]["states"], first[2]["shape"], np.float32)
    np.testing.assert_allclose(out, want, atol=1e-4, rtol=0)
    assert failed[1] == 500 and "did not start on 1 of 2" in failed[2]["error"], failed
    np.testing.assert_array_equal(srv._unb64(again[2]["states"], again[2]["shape"], np.float32),
                                  out)
    assert json.dumps(info)  # the reply is JSON


def test_daemon_stops_after_a_failure_inside_the_rollout(tmp_path):
    """A follower that fails inside its rollout (before the rollout's first
    collective) leaves rank 0 in the mesh's first collective until
    ``--collective_timeout`` (10 s): rank 0 answers that request 500 within
    the timeout and half a minute, stops answering, and both ranks exit
    with the daemon's error (a timed-out gloo group is closed, so the mesh
    cannot serve on)."""
    runs, grid, mask = _daemon_checkpoint(tmp_path)
    body = _body(grid, mask, 3)
    ranks = tmp_path / "ranks"
    # the follower's third rollout (warmup, then the first request) fails
    res = spawn("serve", 2, str(ranks), port=_free_port(), fail_at=3, fail_in="rollout",
                down=True, requests=[body, body],
                argv=["--checkpoint_dir", runs, "--buckets", "3", "--quant", "int8",
                      "--collective_timeout", "10"])
    (_, _, info), first, failed, gone, down = res
    assert first[1] == 200, first
    assert failed[1] == 500 and "failed on 2 of 2 ranks" in failed[2]["error"], failed
    assert 10 <= failed[3] < 40, failed[3]
    assert gone[:2] == ("gone", True), gone
    assert down[0] == "down" and "every rank stops" in down[1]
    assert "every rank stops" in (ranks / "down_1.txt").read_text()


def test_dora_merged_then_int8_on_model_axis(world):
    """DoRA on q, v and o merged on model 2 (o's column norms summed over
    the axis, ``models/lora.merge_lora``), then int8: the forward within
    1e-5 of JAX's merged and quantized model on its mesh; both model ranks
    hold the same row-parallel scales."""
    got = world["res"][3]
    jparams, mesh = _jax_quantized(world, "int8", merge=True)
    scales = [s["backbone.layers.1.attn.o.scale"] for _, s in got["held"]]
    assert all(torch.equal(s, scales[0]) for s in scales)
    states, _, _, _, pos = (np.asarray(t) for t in world["q_batch"])
    want = jax.jit(world["q_model"].forward)(jparams, *jmesh.shard_batch((states, pos), mesh))
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_inference_entry_streams_on_the_mesh(tmp_path):
    """``inference --distributed --streaming`` on 2 ranks (the config's
    model 2: 6 heads a rank of ``fluid/llama-125m`` cut to 1 layer, seeded
    weights): the per-step N-RMSE of one process's run within 1e-5."""
    import csv

    from fluid_llm_tpu_torch import inference

    cfg = Config(**{**STREAM, "llm_layers": 1, "load_dir": "synthetic:1",
                    "parallel": {"model_axis": 2}})
    path = str(tmp_path / "stream.yaml")
    cfg.to_yaml(path)
    argv = ["--config_path", path, "--streaming", "--seq_len", "5", "--pred_steps", "3"]
    spawn("entry", 2, str(tmp_path / "ranks"), entry="inference",
          argv=argv + ["--csv", str(tmp_path / "mesh.csv")])
    inference.main(argv + ["--device", "cpu", "--csv", str(tmp_path / "one.csv")])
    read = lambda p: [float(r["n_rmse"]) for r in csv.DictReader(open(p))]
    got, want = read(tmp_path / "mesh.csv"), read(tmp_path / "one.csv")
    assert len(got) == len(want) == 3
    assert got == pytest.approx(want, rel=1e-5)
