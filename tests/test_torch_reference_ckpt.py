"""The port's reference-checkpoint import/export (``tools/reference_ckpt.py``)
against the JAX package's, on the eight cases of
``tests/test_reference_ckpt.py``.

Both sides hold the same weights: the JAX init of ``tiny_setup``'s
configurations, bridged to the port by ``weights.from_jax_params``.  On the
same reference dict the port's ``import_state_dict`` equals
``from_jax_params`` of the JAX one bit for bit; the port's
``export_state_dict`` equals the JAX one key for key and bit for bit; a
round trip through ``torch.save``/``torch.load`` gives the model's own
``state_dict`` back bit for bit.  ``to_jax_params`` inverts
``from_jax_params``.  Forwards compare with atol 0: the same bits through
the same code.
"""

import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fluid_llm_tpu.tools import reference_ckpt as jref
from fluid_llm_tpu_torch import inference
from fluid_llm_tpu_torch.config import Config
from fluid_llm_tpu_torch.data import make_batches
from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
from fluid_llm_tpu_torch.models import backbone as bb
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.ops.quant import quantize_backbone
from fluid_llm_tpu_torch.tools import reference_ckpt as ref
from fluid_llm_tpu_torch.train import checkpoint as ckpt
from fluid_llm_tpu_torch.weights import from_jax_params, to_jax_params

from test_model import TINY, tiny_setup

torch.set_num_threads(2)

_POS_LN = {"pos_embedding_type": "pos", "in_emb_ln_eps": 1e-5, "input_emb_layer_dropout": 0.0,
           "init_pos_embed": "normal"}
# the configurations of the JAX file's round trips
SETUPS = {
    "opt_lora_mlpgnn": dict(use_lora=True, llm_backbone="facebook/opt-125m",
                            pos_embedding_params=_POS_LN),
    "gpt2_mlp_decoder_cnn_encoder": dict(
        decoder="MLP", encoder_params={"type": "CNN", "num_layers": 2, "hidden_dim": 16,
                                       "activation": "gelu"}),
    "llama_rope": dict(llm_backbone="fluid/llama-125m",
                       pos_embedding_params={"pos_embedding_type": "rope",
                                             "input_emb_layer_dropout": 0.0}),
    "default": {},
}


@functools.cache
def _jax_pair(setup: str):
    """(JAX model, its params): the JAX init, adapters' ``B`` made non-zero."""
    _, _, _, jmodel, _ = tiny_setup(**SETUPS[setup])
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    if "lora" in params:  # B is zero at init: make the adapters matter
        rng = np.random.default_rng(11)
        for layer in params["lora"]["layers"]:
            for leaf in layer["attn"].values():
                leaf["B"] = jnp.asarray(rng.normal(size=leaf["B"].shape).astype(np.float32))
    return jmodel, jax.tree_util.tree_map(np.asarray, params)


def _pair(setup: str):
    """(JAX model, its params, a new port model with the same weights)."""
    jmodel, params = _jax_pair(setup)
    model = FluidLLM.build(Config.from_dict(jmodel.cfg.to_dict()), jmodel.ds_props, **TINY)
    model.load_state_dict(from_jax_params(params))
    return jmodel, params, model


def _torch_roundtrip(sd):
    buf = io.BytesIO()
    torch.save(sd, buf)
    buf.seek(0)
    return torch.load(buf, map_location="cpu", weights_only=True)


def _assert_sd_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = torch.as_tensor(got[k]), torch.as_tensor(want[k])
        assert g.dtype == w.dtype and torch.equal(g, w), k


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(got, np.asarray(want, np.float32), err_msg=path)


def _yaml(cfg: Config) -> str:
    """A config as its YAML file holds it (tuples and lists alike)."""
    return yaml.safe_dump(cfg.to_dict())


def _without_none(tree):
    if isinstance(tree, dict):
        return {k: _without_none(v) for k, v in tree.items() if v is not None}
    if isinstance(tree, (list, tuple)):
        return [_without_none(v) for v in tree]
    return tree


def _check_against_jax(jmodel, params, model, sd_in=None):
    """Export equals JAX's, import of the same dict equals JAX's bridged,
    and the round trip gives the model's state back."""
    sd = ref.export_state_dict(model)
    _assert_sd_equal(sd, jref.export_state_dict(jmodel, params))
    sd = _torch_roundtrip(sd if sd_in is None else sd_in)
    got = ref.import_state_dict(model, sd)
    _assert_sd_equal(got, from_jax_params(jref.import_state_dict(jmodel, sd)))
    _assert_sd_equal(got, model.state_dict())
    return got


@pytest.mark.parametrize("setup", ["opt_lora_mlpgnn", "gpt2_mlp_decoder_cnn_encoder",
                                   "llama_rope"])
def test_roundtrip_matches_jax(setup):
    """OPT + DoRA (peft names) + MLPGNN + learned positions + LN; GPT-2 +
    MLP decoder + CNN encoder; LLaMA with rope (no position leaves)."""
    jmodel, params, model = _pair(setup)
    assert ("lora" in params) == (setup == "opt_lora_mlpgnn")
    _check_against_jax(jmodel, params, model)


@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_to_jax_params_inverts_from_jax_params(setup):
    _, params, model = _pair(setup)
    _assert_tree_equal(to_jax_params(model.state_dict()), _without_none(params))
    _assert_sd_equal(from_jax_params(to_jax_params(model.state_dict())), model.state_dict())


def test_compile_wrapper_segments_are_stripped():
    """``torch.compile`` on the backbone / decoder GNN inserts ``_orig_mod.``
    segments (``model.py:57-59``, ``GNN/decoders.py:211``); the reference's
    ``mesh_edges`` buffer is ignored."""
    jmodel, params, model = _pair("default")
    wrapped = {}
    for k, v in ref.export_state_dict(model).items():
        if k.startswith("backbone."):
            k = "backbone._orig_mod." + k[len("backbone."):]
        wrapped[k.replace(".GNN.", ".GNN._orig_mod.")] = v
    wrapped["output_layer.decoder.mesh_edges"] = torch.zeros(2, 4)
    _check_against_jax(jmodel, params, model, sd_in=wrapped)


def test_unmapped_keys_are_rejected():
    _, _, model = _pair("default")
    sd = ref.export_state_dict(model)
    sd["totally_unknown.weight"] = torch.zeros(3)
    with pytest.raises(ValueError, match="unmapped"):
        ref.import_state_dict(model, sd)


def test_full_payload_file_roundtrip(tmp_path):
    """The reference's save format ``{'params': cfg, 'state_dict',
    'optimizer', 'scheduler'}`` (``src/main.py:133-143``): the embedded
    config dict rebuilds the Config."""
    jmodel, params, model = _pair("default")
    payload = {
        "params": yaml.safe_load(yaml.safe_dump(model.cfg.to_dict())),
        "state_dict": ref.export_state_dict(model),
        "optimizer": {"state": {}, "param_groups": []},
        "scheduler": {"last_epoch": 7},
    }
    torch.save(payload, str(tmp_path / "step_20.pt"))
    sd, cfg = ref.load_reference_checkpoint(str(tmp_path / "step_20.pt"))
    jsd, jcfg = jref.load_reference_checkpoint(str(tmp_path / "step_20.pt"))
    assert _yaml(cfg) == _yaml(model.cfg) and cfg.llm_backbone == jcfg.llm_backbone
    _assert_sd_equal(ref.import_state_dict(model, sd), model.state_dict())
    _assert_sd_equal(ref.import_state_dict(model, sd),
                     from_jax_params(jref.import_state_dict(jmodel, jsd)))


def test_export_embed_table_handling():
    """The frozen HF token table is omitted by default and emitted as given
    when passed in; the extra leaf does not disturb the import."""
    jmodel, params, model = _pair("opt_lora_mlpgnn")
    sd = ref.export_state_dict(model)
    assert [k for k in sd if "embed_tokens" in k or k.endswith("wte.weight")] == []
    table = np.random.default_rng(0).normal(size=(50272, 64)).astype(np.float32)
    sd2 = ref.export_state_dict(model, embed_tokens=table)
    _assert_sd_equal(sd2, jref.export_state_dict(jmodel, params, embed_tokens=table))
    key = "backbone.base_model.model.decoder.embed_tokens.weight"
    np.testing.assert_array_equal(sd2[key].numpy(), table)
    _check_against_jax(jmodel, params, model, sd_in=sd2)


def test_imported_params_run_forward():
    """The imported state loads strictly and gives the same forward, atol 0."""
    _, _, model = _pair("default")
    other = FluidLLM.build(model.cfg, model.ds_props, **TINY)
    other.load_state_dict(ref.import_state_dict(model, ref.export_state_dict(model)))
    ds = SyntheticCylinderDataset(n_trajectories=2, resolution=64, seq_len=5, mode="valid")
    states, _, _, _, pos = next(make_batches(ds, 2, shuffle=False))
    with torch.no_grad():
        torch.testing.assert_close(other(states, pos), model(states, pos), rtol=0, atol=0)


def test_refuses_what_has_no_reference_names():
    _, _, model = _pair("opt_lora_mlpgnn")
    gpt2 = FluidLLM.build(Config.from_dict(dict(model.cfg.to_dict(), llm_backbone="gpt2")),
                          model.ds_props, **TINY)
    with pytest.raises(NotImplementedError, match="GPT-2"):
        ref.export_state_dict(gpt2)
    bb.stack_layers(model.backbone)
    with pytest.raises(ValueError, match="stacked"):
        ref.export_state_dict(model)
    bb.unstack_layers(model.backbone)
    ref.export_state_dict(model)
    quantize_backbone(model.backbone, "int8")
    with pytest.raises(ValueError, match="quantized"):
        ref.export_state_dict(model)
    _, _, plain = _pair("default")
    plain.prepare_inference_params()
    with pytest.raises(ValueError, match="packed q/k/v"):
        ref.export_state_dict(plain)
    moe = FluidLLM.build(Config.from_dict(dict(plain.cfg.to_dict(), moe={"experts": 2})),
                         plain.ds_props, **TINY)
    with pytest.raises(ValueError, match="MoE"):
        ref.export_state_dict(moe)
    with pytest.raises(ValueError, match="MoE"):
        ref.import_state_dict(moe, ref.export_state_dict(_pair("default")[2]))


def test_cli_run_folder_restores_through_inference(tmp_path):
    """``python -m fluid_llm_tpu_torch.tools.reference_ckpt`` writes a run
    folder of the port that ``inference.load_checkpoint_model`` restores:
    the same forward as the exported model (OPT-125m at its width, one
    layer, DoRA: the CLI builds from the config, without overrides), atol 0."""
    cfg = Config(llm_backbone="facebook/opt-125m", llm_layers=1, half_precision=False,
                 batch_size=2,
                 autoreg_seq_len=5, seq_len=5, resolution=64, flash_attention=False,
                 load_dir="synthetic:2",
                 decoder_params={"type": "MLPGNN", "gnn_dim": 8, "gnn_hid_dim": 12,
                                 "gnn_layers": 2, "gnn_heads": 1, "mlp_hid_dim": 32,
                                 "dropout": 0.0},
                 encoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32,
                                 "activation": "leakyrelu"})
    ds = SyntheticCylinderDataset(n_trajectories=2, resolution=64, seq_len=5, mode="valid")
    model = FluidLLM.build(cfg, ds.ds_props())
    model.init_weights(torch.Generator().manual_seed(9))
    torch.save({"params": yaml.safe_load(yaml.safe_dump(cfg.to_dict())),
                "state_dict": ref.export_state_dict(model)}, str(tmp_path / "ref.pt"))
    path = ref.main([str(tmp_path / "ref.pt"), "--save_dir", str(tmp_path / "runs" / "imported")])
    assert path.endswith("step_0")

    run = ckpt.get_save_folder(str(tmp_path / "runs"), -1)
    assert ckpt.latest_step(run) == 0 and _yaml(ckpt.load_config(run)) == _yaml(cfg)
    restored = inference.load_checkpoint_model(run, 0, torch.device("cpu"))
    model.prepare_inference_params()
    states, _, _, _, pos = next(make_batches(ds, 2, shuffle=False))
    with torch.no_grad():
        torch.testing.assert_close(restored(states, pos), model.eval()(states, pos),
                                   rtol=0, atol=0)
