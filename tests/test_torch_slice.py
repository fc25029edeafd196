"""The ported serving slice end to end against the JAX package.

The tiny configuration of ``tests/test_model.py`` (GPT-2 layout, 2 layers,
d 64, see-init, BOS, MLPGNN, f32), here with DoRA adapters whose ``B`` is
made non-zero so the merge matters.  The JAX side applies the adapters
unmerged; the port merges them (``prepare_inference_params``).  Weights are
the JAX init, bridged by ``weights.from_jax_params``; data comes from each
package's own synthetic dataset, which are checked equal first.
Tolerance atol 1e-4 on states and diffs: f32, 6 chained steps.
"""

import pkgutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_llm_tpu import inference as jinference
from fluid_llm_tpu.config import Config
from fluid_llm_tpu.data.pipeline import make_batches as jmake_batches
from fluid_llm_tpu.data.synthetic import SyntheticCylinderDataset as JSynthetic
from fluid_llm_tpu.models.fluid_llm import FluidLLM as JFluidLLM
from fluid_llm_tpu.ops.patching import patch_to_img as jpatch_to_img
from fluid_llm_tpu.rollout.generate import generate as jgenerate
from fluid_llm_tpu_torch import inference
from fluid_llm_tpu_torch.data import make_batches
from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.rollout.generate import gen_seq, generate
from fluid_llm_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

SEQ_LEN = 5
TINY = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, max_pos=128, dropout=0.0)
CFG = dict(
    llm_backbone="gpt2", half_precision=False, use_lora=True, batch_size=2,
    autoreg_seq_len=SEQ_LEN, seq_len=SEQ_LEN, resolution=64, flash_attention=False,
    lora_config={"r": 4, "lora_alpha": 16, "use_dora": True},
    decoder_params={"type": "MLPGNN", "gnn_dim": 8, "gnn_hid_dim": 12, "gnn_layers": 2,
                    "gnn_heads": 1, "mlp_hid_dim": 32, "dropout": 0.0},
    encoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32,
                    "activation": "leakyrelu"},
)


@pytest.fixture(scope="module")
def pair():
    cfg = Config(**CFG)
    jds = JSynthetic(n_trajectories=2, resolution=64, seq_len=SEQ_LEN, mode="valid")
    tds = SyntheticCylinderDataset(n_trajectories=2, resolution=64, seq_len=SEQ_LEN, mode="valid")
    jmodel = JFluidLLM.build(cfg, jds.ds_props(), **TINY)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    for layer in params["lora"]["layers"]:
        for leaf in layer["attn"].values():
            leaf["B"] = jnp.asarray(rng.normal(size=leaf["B"].shape).astype(np.float32) * 0.05)

    model = FluidLLM.build(cfg, tds.ds_props(), **TINY)
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    model.prepare_inference_params()
    return jmodel, params, jds, model, tds


def test_datasets_and_batches_match(pair):
    _, _, jds, _, tds = pair
    assert vars(tds.ds_props()) == vars(jds.ds_props())
    jb = next(jmake_batches(jds, 2, shuffle=False))
    tb = next(make_batches(tds, 2, shuffle=False))
    for t, j in zip(tb, jb):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)


def test_weight_bridge_covers_every_parameter(pair):
    """Every JAX leaf lands on a port parameter of the same shape, and back."""
    jmodel, params, _, _, tds = pair
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    ours = FluidLLM.build(jmodel.cfg, tds.ds_props(), **TINY).state_dict()
    assert sorted(sd) == sorted(ours)
    assert all(sd[k].shape == ours[k].shape for k in sd)
    assert "backbone.layers.1.attn.q.weight" in sd and "lora.layers.1.attn.v.m" in sd


@pytest.mark.parametrize("n_valid", [SEQ_LEN - 1, 2])
def test_forward_matches_jax(pair, n_valid):
    """Every frame decoded (``forward``), dense and with the last frames
    marked invalid (rows of invalid frames are compared too: same math)."""
    jmodel, params, jds, model, tds = pair
    states, _, _, _, pos = next(make_batches(tds, 2, shuffle=False))
    valid = (torch.arange(states.shape[1])[None] < n_valid).expand(2, -1)
    ref = jax.jit(lambda p, x, i, v: jmodel.forward(p, x, i, frame_valid=v))(
        params, jnp.asarray(states.numpy()), jnp.asarray(pos.numpy()), jnp.asarray(valid.numpy()))
    with torch.no_grad():
        got = model(states, pos, frame_valid=valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_generate_matches_jax(pair):
    """6-step rollout: the window fills (W=5) and then slides."""
    jmodel, params, jds, model, tds = pair
    states, _, _, bc, pos = next(jmake_batches(jds, 2, shuffle=False))
    js, jd = jgenerate(jmodel, params, states[:, :1], bc, pos, 6)
    tstates, _, _, tbc, tpos = next(make_batches(tds, 2, shuffle=False))
    ts, td = generate(model, tstates[:, :1], tbc, tpos, 6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)

    # gen_seq: the first 4 steps as images (steps are sequential, so a
    # 4-step rollout is the prefix of the 6-step one)
    imgs, diffs = gen_seq(model, (tstates, None, None, tbc, tpos), 4)
    np.testing.assert_allclose(imgs.numpy(), np.asarray(jpatch_to_img(js[:, :5], jmodel.ds_props)),
                               atol=1e-4)
    np.testing.assert_allclose(diffs.numpy(), np.asarray(jpatch_to_img(jd[:, :4], jmodel.ds_props)),
                               atol=1e-4)


def test_test_generate_nrmse_matches_jax(pair):
    jmodel, params, jds, model, tds = pair
    jper, jmean = jinference.test_generate(jmodel, params, jds, batch_size=2, pred_steps=4)
    per, mean = inference.test_generate(model, tds, batch_size=2, pred_steps=4)
    np.testing.assert_allclose(per, jper, rtol=1e-4)
    assert abs(mean - jmean) <= 1e-4 * abs(jmean)


def test_inference_main_writes_per_step_csv(tmp_path):
    """The entry point end to end on the CPU: YAML -> seeded weights (bf16,
    the config's ``half_precision``) -> rollout -> per-step N-RMSE CSV."""
    import yaml

    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump({**CFG, "half_precision": True, "llm_layers": 2,
                                    "load_dir": "synthetic:1"}))
    out = tmp_path / "n_rmse.csv"
    mean = inference.main(["--config_path", str(path), "--device", "cpu", "--seq_len",
                           str(SEQ_LEN), "--pred_steps", "3", "--csv", str(out)])
    rows = out.read_text().splitlines()
    assert rows[0] == "step,n_rmse" and len(rows) == 4
    per_step = [float(r.split(",")[1]) for r in rows[1:]]
    assert np.all(np.isfinite(per_step)) and mean == pytest.approx(np.mean(per_step))


def test_get_device_raises_without_cuda(monkeypatch):
    """Asking for the card where there is none fails; it never runs on the host."""
    from fluid_llm_tpu_torch.utils import get_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_device("cuda")
    assert get_device("cpu") == torch.device("cpu")


def test_init_weights_is_seeded():
    """Weights drawn from a torch.Generator: same seed, same weights; the
    DoRA magnitude starts at the base weight's row norms."""
    cfg = Config(**CFG)
    props = SyntheticCylinderDataset(n_trajectories=1, resolution=64, seq_len=SEQ_LEN).ds_props()
    a, b = (FluidLLM.build(cfg, props, **TINY) for _ in range(2))
    a.init_weights(torch.Generator().manual_seed(3))
    b.init_weights(torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    q = a.backbone.layers[0].attn["q"].weight
    torch.testing.assert_close(a.lora.layers[0]["attn"]["q"].m, q.norm(dim=1))


def test_port_imports_no_jax():
    """Importing every module of the port loads no jax."""
    import fluid_llm_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(fluid_llm_tpu_torch.__path__,
                                                   "fluid_llm_tpu_torch.")]
    assert {"fluid_llm_tpu_torch.rollout.generate", "fluid_llm_tpu_torch.main",
            "fluid_llm_tpu_torch.continue_train", "fluid_llm_tpu_torch.train.trainer",
            "fluid_llm_tpu_torch.train.loop", "fluid_llm_tpu_torch.ops.flash_attention"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for name in {['fluid_llm_tpu_torch'] + names!r}:\n"
        "    importlib.import_module(name)\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
