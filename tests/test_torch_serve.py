"""The serving daemon of the port (``tools/serve.py``, ``tools/serving_bench.py``)
against the JAX package's, on the CPU.

The engines are built directly from the same tiny model on both sides
(GPT-2 layout, 2 layers at d 128 so every linear is one the int8 kernels
take; the JAX init bridged by ``weights.from_jax_params``), as
``tests/test_serve.py`` builds its engine; ``load_engine`` is driven from a
checkpoint the port writes.  Tolerances: the compact batch equal (its
states within 1e-6); rollouts in f32 within 1e-4 absolute (physical units,
magnitudes ~1; the same math summed in another order); the int8 engine
within 0.05 of the dense one in mean absolute difference over the dense
output's mean magnitude (``tests/test_serve.py:233``).
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from fluid_llm_tpu.config import Config as JConfig
from fluid_llm_tpu.data.synthetic import SyntheticCylinderDataset as JSynthetic
from fluid_llm_tpu.models.fluid_llm import FluidLLM as JFluidLLM
from fluid_llm_tpu.ops.quant import quantize_backbone as jquantize_backbone
from fluid_llm_tpu.tools import serve as jsrv
from fluid_llm_tpu_torch.config import Config
from fluid_llm_tpu_torch.core.interp import resample_to_grid
from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.ops import quant
from fluid_llm_tpu_torch.ops.patching import patch_to_img
from fluid_llm_tpu_torch.rollout.generate import generate
from fluid_llm_tpu_torch.tools import serve as srv
from fluid_llm_tpu_torch.tools import serving_bench as sb
from fluid_llm_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

SEQ_LEN = 8
TINY = dict(n_layers=2, d_model=128, n_heads=4, d_ff=256, max_pos=128, dropout=0.0)
CFG = dict(
    llm_backbone="gpt2", half_precision=False, use_lora=False, batch_size=2,
    autoreg_seq_len=SEQ_LEN, seq_len=SEQ_LEN, resolution=64, flash_attention=False,
    decoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32,
                    "activation": "leakyrelu", "zero_last_layer": False},
    encoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32, "activation": "leakyrelu"},
)
ATOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _datasets():
    kw = dict(n_trajectories=2, resolution=64, seq_len=SEQ_LEN, mode="valid")
    return JSynthetic(**kw), SyntheticCylinderDataset(**kw)


def _port_model(params, quant_mode=None, qmm_mode="w8a8"):
    _, tds = _datasets()
    model = FluidLLM.build(Config(**CFG), tds.ds_props(), **TINY)
    model.load_state_dict(from_jax_params(_np(params)))
    model.prepare_inference_params(quant_mode, qmm_mode)
    return model.eval()


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) on the same weights, buckets 3 and 6."""
    jds, tds = _datasets()
    jcfg = JConfig(**CFG)
    jmodel = JFluidLLM.build(jcfg, jds.ds_props(), **TINY)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    jeng = jsrv.RolloutEngine(jcfg, jmodel, jmodel.prepare_inference_params(params), jds,
                              buckets=[3, 6], streaming=False)
    model = _port_model(params)
    return jeng, srv.RolloutEngine(model.cfg, model, tds, buckets=[3, 6], streaming=False), params


def _client_frames(ds, n=1, traj=0):
    """Raw grid frames + mask of one synthetic trajectory."""
    src = ds.get_trajectory(traj)
    grid = resample_to_grid(torch.from_numpy(src.node_states[:n]), torch.from_numpy(src.vert_idx),
                            torch.from_numpy(src.weights), torch.from_numpy(src.mask))
    return grid.numpy(), np.asarray(src.mask, np.uint8)


def test_predict_matches_jax_in_physical_units(engines):
    jeng, eng, _ = engines
    grid, mask = _client_frames(eng.dataset)
    pred = eng.predict(grid, mask, pred_steps=3)
    assert pred.shape == (3, 3, *grid.shape[-2:]) and np.isfinite(pred).all()
    inside = ~mask.astype(bool)
    assert abs(pred[0, 0][inside].mean() - grid[0, 0][inside].mean()) < 10 * (
        abs(grid[0, 0][inside].mean()) + 1)
    np.testing.assert_allclose(pred, jeng.predict(grid, mask, pred_steps=3), atol=ATOL, rtol=0)


def test_bucket_dispatch(engines):
    """The rollout runs to the bucket's length; the request's steps return,
    equal to the JAX engine's."""
    jeng, eng, _ = engines
    grid, mask = _client_frames(eng.dataset)
    got = eng.predict(grid, mask, pred_steps=2)
    assert got.shape[0] == 2
    np.testing.assert_allclose(got, jeng.predict(grid, mask, pred_steps=2), atol=ATOL, rtol=0)
    assert eng.pick_bucket(2) == 3 and eng.pick_bucket(4) == 6
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        eng.pick_bucket(7)


@pytest.mark.parametrize("ctx,start_step", [(1, 0), (2, 40)])
def test_build_batch_matches_jax(engines, ctx, start_step):
    """The compact batch equals the JAX engine's, and the dataset sample on
    the frames the rollout reads."""
    jeng, eng, _ = engines
    grid, mask = _client_frames(eng.dataset, n=ctx)
    got = eng.build_batch(grid, mask.astype(bool), bucket=3, start_step=start_step)
    want = jeng.build_batch(grid, mask.astype(bool), bucket=3, start_step=start_step)
    assert [tuple(t.shape) for t in got] == [a.shape for a in want]
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    sample = eng.dataset.sample(0, step_num=0)
    np.testing.assert_allclose(got[0][0].numpy(), sample[0][:ctx].numpy(), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[1][0, 0].numpy(), sample[3][0].numpy())


def test_request_coalescing_matches_unbatched(engines):
    """max_batch > 1: concurrent requests coalesce into one batched rollout
    padded to max_batch and each gets its unbatched result."""
    from concurrent.futures import ThreadPoolExecutor

    _, eng, _ = engines
    batched = srv.RolloutEngine(eng.cfg, eng.model, eng.dataset, buckets=[3, 6],
                                streaming=False, max_batch=3, batch_window_ms=500.0)
    grid, mask = _client_frames(eng.dataset)
    grid2 = grid * 1.1
    calls = []
    orig = batched._device_rollout
    batched._device_rollout = lambda b, c, batch: calls.append(batch[0].shape[0]) or orig(b, c,
                                                                                           batch)
    with ThreadPoolExecutor(3) as pool:
        futs = [pool.submit(batched.request, grid, mask, 3, 0),
                pool.submit(batched.request, grid2, mask, 2, 0),
                pool.submit(batched.request, grid, mask, 5, 0)]  # the other bucket
        out = [f.result(timeout=300) for f in futs]
    np.testing.assert_allclose(out[0], eng.predict(grid, mask, 3), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out[1], eng.predict(grid2, mask, 2), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out[2], eng.predict(grid, mask, 5), rtol=1e-4, atol=1e-5)
    assert sorted(calls) == [1, 3]
    assert batched.stats()["coalesced_groups"] == 1 and batched.stats()["padded_rows"] == 1


def test_multi_frame_context_conditions_rollout(engines):
    """ctx > 1: both context frames condition the rollout (start_state=ctx),
    as the JAX engine's."""
    jeng, eng, _ = engines
    grid, mask = _client_frames(eng.dataset, n=2)
    pred = eng.predict(grid, mask, pred_steps=2)
    assert pred.shape == (2, 3, *grid.shape[-2:]) and np.isfinite(pred).all()
    init, bcm, pos = eng.build_batch(grid, mask.astype(bool), bucket=3)
    assert init.shape[1] == 2
    st, _ = generate(eng.model, init, bcm, pos, 3)
    ref = eng._to_client_grid(patch_to_img(st, eng.model.ds_props).numpy()[0, 2:4])
    np.testing.assert_allclose(pred, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pred, jeng.predict(grid, mask, pred_steps=2), atol=ATOL, rtol=0)
    assert not np.allclose(pred, eng.predict(grid[1:], mask, pred_steps=2), atol=1e-3)


def test_rejects_oversized_context(engines):
    _, eng, _ = engines
    grid, mask = _client_frames(eng.dataset)
    with pytest.raises(ValueError, match="context length"):
        eng.predict(np.repeat(grid, eng.model.max_ctx_len + 1, axis=0), mask, pred_steps=2)


def test_http_round_trip(engines):
    _, eng, _ = engines
    httpd = srv.serve(eng, host="127.0.0.1", port=0)  # ephemeral port
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.load(r)["status"] == "ok"
        with urllib.request.urlopen(f"{base}/v1/info", timeout=30) as r:
            info = json.load(r)
        grid, mask = _client_frames(eng.dataset)
        assert info["buckets"] == [3, 6] and info["grid_hw"] == list(mask.shape)
        assert info["streaming"] is False and info["max_ctx"] == eng.model.max_ctx_len
        body = json.dumps({"states": srv._b64(grid.astype(np.float32)), "shape": list(grid.shape),
                           "mask": srv._b64(mask), "pred_steps": 2}).encode()
        req = urllib.request.Request(f"{base}/v1/rollout", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.load(r)
        pred = srv._unb64(out["states"], out["shape"], np.float32)
        np.testing.assert_allclose(pred, eng.predict(grid, mask, 2), rtol=1e-5, atol=1e-6)
        assert out["steps_per_s"] > 0
        with urllib.request.urlopen(f"{base}/v1/stats", timeout=30) as r:
            stats = json.load(r)
        assert stats["requests"] >= 1 and stats["device_calls"] >= 1
        assert stats["latency_ms"]["count"] >= 1 and stats["latency_ms"]["p50"] > 0
        assert any(k.startswith("bucket=3") for k in stats["by_program"])
        assert set(stats) >= {"errors", "device_ms_total", "coalesced_groups", "padded_rows",
                              "compiled_programs"}
        bad = urllib.request.Request(f"{base}/v1/rollout", data=b"{}",
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=30)
        assert e.value.code == 400
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.load(r)["status"] == "ok"
    finally:
        httpd.shutdown()


def test_quantized_engine_matches_dense_and_jax(engines):
    """int8 storage: the w8a8 engine within 0.05 of the dense one; the
    w8a16 engine (dequantise, then the matmul) equals the JAX int8 engine
    (its default XLA dequant path) on the same int8 weights."""
    jeng, eng, params = engines
    grid, mask = _client_frames(eng.dataset)
    dense = eng.predict(grid, mask, pred_steps=3)
    for mode in ("w8a8", "w8a16"):
        model = _port_model(params, "int8", mode)
        assert isinstance(model.backbone.layers[0].mlp["fc1"], quant.QuantLinear)
        qeng = srv.RolloutEngine(model.cfg, model, eng.dataset, buckets=[3], streaming=False)
        got = qeng.predict(grid, mask, pred_steps=3)
        assert np.isfinite(got).all()
        assert np.abs(got - dense).mean() / (np.abs(dense).mean() + 1e-6) < 0.05
    jq = dict(params, backbone=jquantize_backbone(params["backbone"], mode="int8"))
    jqeng = jsrv.RolloutEngine(jeng.cfg, jeng.model, jeng.model.prepare_inference_params(jq),
                               jeng.dataset, buckets=[3], streaming=False)
    np.testing.assert_allclose(got, jqeng.predict(grid, mask, pred_steps=3), atol=ATOL, rtol=0)


def test_load_engine_from_a_checkpoint(tmp_path):
    """``load_engine`` restores a port checkpoint (GPT-2 at full width cut
    to 1 layer, DoRA unmerged), merges the adapters, stores the backbone as
    int8 and serves on the CPU; ``streaming='auto'`` picks the exact
    rollout for learned positions."""
    from fluid_llm_tpu_torch.train import checkpoint as ckpt

    cfg = Config(**{**CFG, "llm_layers": 1, "use_lora": True,
                    "lora_config": {"r": 4, "lora_alpha": 16, "use_dora": True}})
    _, tds = _datasets()
    model = FluidLLM.build(cfg, tds.ds_props())
    model.init_weights(torch.Generator().manual_seed(0))
    run = ckpt.make_save_folder(str(tmp_path / "runs"))
    ckpt.save_checkpoint(run, 1, model, torch.optim.SGD(model.parameters(), lr=0.0), 0, cfg)
    eng = srv.load_engine(str(tmp_path / "runs"), buckets=(3,), quant="int8", qmm_mode="w8a8",
                          device="cpu")
    assert not eng.streaming and eng.model.lora is None
    assert all(isinstance(m, quant.QuantLinear) and m.scale.dtype == torch.float32
               for m in eng.model.backbone.layers[0].attn.values())
    grid, mask = _client_frames(eng.dataset)
    eng.warmup()
    pred = eng.request(grid, mask, 3)
    assert pred.shape == (3, 3, *grid.shape[-2:]) and np.isfinite(pred).all()


def test_serving_bench_one_mask_per_stream(engines):
    """``client_contexts`` returns each trajectory's own mask (the JAX
    bench handed every stream the last one); both modes serve every stream
    its full bucket."""
    _, eng, _ = engines
    ds = eng.dataset
    frames, masks = sb.client_contexts(ds, 2)
    assert len(frames) == len(masks) == 2
    for i in range(2):
        np.testing.assert_array_equal(masks[i], np.asarray(ds.get_trajectory(i).mask, np.uint8))
        np.testing.assert_array_equal(frames[i], _client_frames(ds, traj=i)[0])
    assert not np.array_equal(masks[0], masks[1])
    serial = sb.run_mode("serial", eng.cfg, eng.model, ds, 3, frames, masks, reps=2,
                         streaming=False)
    batched = sb.run_mode("batched", eng.cfg, eng.model, ds, 3, frames, masks, reps=2,
                          streaming=False)
    assert serial["aggregate_steps_per_sec"] > 0 and serial["coalesced_groups"] == 0
    assert batched["coalesced_groups"] >= 1
