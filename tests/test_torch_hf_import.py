"""The port's HF import (``models/hf_import.py``) against the JAX package's.

Randomly initialised HF models built from config (no download): the
port's converted ``Backbone.state_dict()`` equals ``from_jax_params`` of
the JAX ``convert_state_dict`` on the same state dict bit for bit, and the
port's backbone reproduces HF's ``last_hidden_state`` on ``inputs_embeds``
within the JAX test's tolerances (atol 2e-5; 3e-5 for LLaMA: f32, another
summation order).  The port's snapshot reader gives the same tensors as
``transformers`` reading the same folder; the entry points import before
nf4 and ``continue_train`` never imports.
"""

import logging
import os

# the hub stays offline: every load in this file reads a local folder
os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import yaml  # noqa: E402
from transformers import (  # noqa: E402
    AutoModel, GPT2Config, GPT2LMHeadModel, GPT2Model, LlamaConfig, LlamaForCausalLM, LlamaModel,
    OPTConfig, OPTForCausalLM, OPTModel,
)

from fluid_llm_tpu.models import backbone as jbb  # noqa: E402
from fluid_llm_tpu.models.hf_import import convert_state_dict as jconvert  # noqa: E402
from fluid_llm_tpu_torch import continue_train, inference  # noqa: E402
from fluid_llm_tpu_torch import main as tmain  # noqa: E402
from fluid_llm_tpu_torch.config import Config  # noqa: E402
from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset  # noqa: E402
from fluid_llm_tpu_torch.models import backbone as bb  # noqa: E402
from fluid_llm_tpu_torch.models import hf_import  # noqa: E402
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM  # noqa: E402
from fluid_llm_tpu_torch.ops.quant import NF4Linear, quantize_backbone  # noqa: E402
from fluid_llm_tpu_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(2)

# (HF model, its config, the backbone config both packages build, atol)
_OPT = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, ffn_dim=64,
            max_position_embeddings=64, vocab_size=100, dropout=0.0, activation_function="relu")
_BB_OPT = dict(family="opt", n_layers=2, d_model=32, n_heads=4, d_ff=64, max_pos=64,
               act="relu", pos="learned", pos_offset=2, dropout=0.0)
_LLAMA = dict(hidden_size=32, intermediate_size=64, vocab_size=100, max_position_embeddings=64,
              rms_norm_eps=1e-6, attention_dropout=0.0)
_BB_LLAMA = dict(family="llama", d_model=32, n_heads=4, d_ff=64, max_pos=64, act="silu",
                 norm="rmsnorm", pos="rope", ln_eps=1e-6, dropout=0.0)
CASES = {
    "opt": (OPTModel, OPTConfig(**_OPT, word_embed_proj_dim=32, do_layer_norm_before=True),
            _BB_OPT, 2e-5),
    # OPT-350m's layout: word_embed_proj_dim < hidden_size (project_in/out,
    # no bias), post-LN blocks, no final layer norm
    "opt_350m_layout": (OPTModel, OPTConfig(**_OPT, word_embed_proj_dim=16,
                                            do_layer_norm_before=False),
                        dict(_BB_OPT, d_embed=16, pre_ln=False, final_ln=False), 2e-5),
    "gpt2": (GPT2Model, GPT2Config(n_embd=32, n_layer=2, n_head=4, n_inner=64, n_positions=64,
                                   vocab_size=100, resid_pdrop=0.0, attn_pdrop=0.0,
                                   embd_pdrop=0.0),
             dict(family="gpt2", n_layers=2, d_model=32, n_heads=4, d_ff=64, max_pos=64,
                  act="gelu_new", pos="learned", dropout=0.0), 2e-5),
    "llama": (LlamaModel, LlamaConfig(**_LLAMA, num_hidden_layers=2, num_attention_heads=4,
                                      num_key_value_heads=4),
              dict(_BB_LLAMA, n_layers=2), 3e-5),
    # grouped-query attention: k/v at 2 heads of the 4
    "llama_gqa": (LlamaModel, LlamaConfig(**_LLAMA, num_hidden_layers=1, num_attention_heads=4,
                                          num_key_value_heads=2),
                  dict(_BB_LLAMA, n_layers=1, n_kv_heads=2), 3e-5),
}


def _hf(case: str, cls=None):
    base, hcfg, bcfg, atol = CASES[case]
    torch.manual_seed(0)
    return (cls or base)(hcfg).eval(), bcfg, atol


def _assert_state_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("case", sorted(CASES))
def test_conversion_equals_jax_and_forward_matches_hf(case):
    hf, bcfg, atol = _hf(case)
    sd = hf.state_dict()
    state, embed = hf_import.backbone_state_dict(sd, bb.BackboneConfig(**bcfg))
    jparams, jembed = jconvert(sd, jbb.BackboneConfig(**bcfg, attn_impl="xla"))
    _assert_state_equal(state, from_jax_params(jparams))
    np.testing.assert_array_equal(embed, jembed)
    assert embed.shape == (100, bcfg.get("d_embed") or 32)

    model = bb.Backbone(bb.BackboneConfig(**bcfg))
    model.load_state_dict(state)  # strict: every parameter, nothing left over
    emb = (np.random.default_rng(1).normal(size=(2, 9, model.cfg.embed_dim)) * 0.3
           ).astype(np.float32)
    with torch.no_grad():
        ref = hf(inputs_embeds=torch.from_numpy(emb)).last_hidden_state.numpy()
        got = model(torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(got, ref, atol=atol)


def test_opt_350m_random_init_matches_layout():
    """The port's OPT-350m backbone has the HF conversion's layout (and the
    JAX init's): project_in/out, no final norm, 512-wide in and out."""
    cfg = bb.preset("facebook/opt-350m", llm_layers=2)
    model = bb.Backbone(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    jtree = jbb.init_params(jax.random.PRNGKey(0), jbb.preset("facebook/opt-350m", llm_layers=2))
    jsd = from_jax_params(jax.tree_util.tree_map(np.asarray, jtree))
    assert sorted(sd) == sorted(jsd)
    assert all(sd[k].shape == jsd[k].shape for k in sd)
    assert sd["project_in.weight"].shape == (1024, 512)
    assert sd["project_out.weight"].shape == (512, 1024)
    assert not any(k.startswith("final_norm") for k in sd)
    with torch.no_grad():
        assert model(torch.zeros(1, 4, 512)).shape == (1, 4, 512)


# -- the local cache -----------------------------------------------------------


def _write_snapshot(cache, name: str, model, **save_kw) -> str:
    repo = cache / ("models--" + name.replace("/", "--"))
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text("0123abcd")
    model.save_pretrained(str(repo / "snapshots" / "0123abcd"), **save_kw)
    return str(repo / "snapshots" / "0123abcd")


# (HF class saved, save_pretrained kwargs, the file the reader must name);
# the LMHead classes carry ``model.`` / ``transformer.`` prefixes and lm_head
SNAPSHOTS = {
    "opt_safetensors": ("opt", OPTModel, dict(safe_serialization=True), "model.safetensors"),
    "opt_causal_lm_safetensors": ("opt", OPTForCausalLM, dict(safe_serialization=True),
                                  "model.safetensors"),
    "opt_causal_lm_bin": ("opt", OPTForCausalLM, dict(safe_serialization=False),
                          "pytorch_model.bin"),
    "opt_sharded": ("opt", OPTModel, dict(safe_serialization=True, max_shard_size="20KB"),
                    "model.safetensors.index.json"),
    "opt_bf16": ("opt", OPTModel, dict(safe_serialization=True), "model.safetensors"),
    "gpt2_lm_head_bin": ("gpt2", GPT2LMHeadModel, dict(safe_serialization=False),
                         "pytorch_model.bin"),
    "llama_causal_lm_sharded_bin": ("llama_gqa", LlamaForCausalLM,
                                    dict(safe_serialization=False, max_shard_size="20KB"),
                                    "pytorch_model.bin.index.json"),
}


@pytest.mark.parametrize("snap", sorted(SNAPSHOTS))
def test_snapshot_reader_equals_transformers_path(snap, tmp_path, monkeypatch, caplog):
    """``load_pretrained`` of one cached snapshot (the port's reader, the
    file named in the log) against ``transformers``' ``AutoModel`` reading
    the same folder: the same converted tensors, bit for bit."""
    case, cls, save_kw, fname = SNAPSHOTS[snap]
    hf, bcfg, _ = _hf(case, cls)
    if snap.endswith("bf16"):
        hf = hf.to(torch.bfloat16)
    folder = _write_snapshot(tmp_path, "tiny/model", hf, **save_kw)
    assert os.path.exists(os.path.join(folder, fname))
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    monkeypatch.setitem(bb.PRESETS, "tiny/model", bb.BackboneConfig(**bcfg))
    caplog.set_level(logging.INFO, logger="fluid_llm_tpu_torch.hf_import")

    state, embed, cfg = hf_import.load_pretrained("tiny/model")
    assert f"Read pretrained tiny/model from {os.path.join(folder, fname)}" in caplog.text
    ref = AutoModel.from_pretrained(folder, local_files_only=True).state_dict()
    want, want_embed = hf_import.backbone_state_dict(ref, cfg)
    _assert_state_equal(state, want)
    np.testing.assert_array_equal(embed, want_embed)
    assert cfg == bb.BackboneConfig(**bcfg) and embed.dtype == np.float32
    bb.Backbone(cfg).load_state_dict(state)


def test_safetensors_reader_takes_stored_dtypes(tmp_path):
    """F32, F16 and BF16 read bit for bit; another dtype raises."""
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(3)
    tensors = {f"t.{d}": torch.randn(3, 5, generator=g).to(d)
               for d in (torch.float32, torch.float16, torch.bfloat16)}
    save_file(tensors, str(tmp_path / "a.safetensors"))
    got = hf_import.read_safetensors(str(tmp_path / "a.safetensors"))
    _assert_state_equal(got, tensors)
    save_file({"i": torch.arange(4)}, str(tmp_path / "b.safetensors"))
    with pytest.raises(ValueError, match="dtype I64"):
        hf_import.read_safetensors(str(tmp_path / "b.safetensors"))


def test_hub_cache_resolution(monkeypatch, tmp_path):
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "home"))
    assert hf_import.hub_cache() == str(tmp_path / "home" / "hub")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    assert hf_import.hub_cache() == str(tmp_path / "hub")
    monkeypatch.delenv("HF_HUB_CACHE")
    monkeypatch.delenv("HF_HOME")
    monkeypatch.setenv("HOME", str(tmp_path))
    assert hf_import.hub_cache() == str(tmp_path / ".cache" / "huggingface" / "hub")


@pytest.mark.parametrize("missing", ["repo", "snapshot", "weights"])
def test_empty_cache_gives_none_and_random_init(tmp_path, monkeypatch, caplog, missing):
    """No cache entry, a ``refs/main`` naming no snapshot folder, a
    snapshot without weight files: None, the reason and JAX's line logged,
    the draw kept."""
    repo = tmp_path / "models--facebook--opt-125m"
    if missing != "repo":
        (repo / "refs").mkdir(parents=True)
        (repo / "refs" / "main").write_text("0123abcd")
    if missing == "weights":
        (repo / "snapshots" / "0123abcd").mkdir(parents=True)
        (repo / "snapshots" / "0123abcd" / "config.json").write_text("{}")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    caplog.set_level(logging.INFO)
    assert hf_import.load_pretrained("facebook/opt-125m", 2) is None
    assert "Pretrained facebook/opt-125m not read from" in caplog.text
    assert "FileNotFoundError" in caplog.text

    cfg = Config(**CFG)
    model = FluidLLM.build(cfg, _props(), **TINY)
    model.init_weights(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert tmain.import_pretrained(model) is False
    assert "Pretrained facebook/opt-125m unavailable; using random init" in caplog.text
    _assert_state_equal(model.state_dict(), before)


# -- the entry points ------------------------------------------------------------

SEQ_LEN = 4
TINY = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, max_pos=128, dropout=0.0)
CFG = dict(
    llm_backbone="facebook/opt-125m", half_precision=False, use_lora=True, batch_size=2,
    autoreg_seq_len=SEQ_LEN, seq_len=SEQ_LEN, resolution=64, flash_attention=False,
    lora_config={"r": 4, "lora_alpha": 16, "use_dora": True, "lora_dropout": 0.0},
    decoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32,
                    "activation": "leakyrelu", "zero_last_layer": False},
    encoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32, "activation": "leakyrelu"},
)


def _props():
    return SyntheticCylinderDataset(n_trajectories=1, resolution=64, seq_len=SEQ_LEN,
                                    mode="valid").ds_props()


def _tiny_opt_pretrained():
    """An HF OPT at TINY's shapes, converted: ``load_pretrained``'s result."""
    torch.manual_seed(5)
    hf = OPTModel(OPTConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                            ffn_dim=128, max_position_embeddings=128, vocab_size=100,
                            word_embed_proj_dim=64, dropout=0.0, activation_function="relu"))
    cfg = bb.preset("facebook/opt-125m").replace(**TINY)
    state, embed = hf_import.backbone_state_dict(hf.state_dict(), cfg)
    return state, embed, cfg


@pytest.mark.parametrize("nf4", [False, True])
def test_build_model_and_trainer_imports_before_nf4(monkeypatch, caplog, nf4):
    """The imported backbone, BOS = its token table's BOS row, DoRA's
    magnitudes = the norms of the random draw (the JAX order: the adapters
    are drawn with the backbone, before the import); with
    ``llm_4bit_loading`` the nf4 storage equals quantizing the imported
    weights."""
    state, embed, bcfg = _tiny_opt_pretrained()
    calls = []
    monkeypatch.setattr(tmain, "load_pretrained",
                        lambda name, layers: calls.append((name, layers)) or (state, embed, bcfg))
    caplog.set_level(logging.INFO, logger="fluid_llm_tpu_torch.main")
    cfg = Config(**CFG, llm_4bit_loading=nf4)
    model = tmain.build_model_and_trainer(cfg, _props(), torch.device("cpu"), **TINY).model
    assert calls == [("facebook/opt-125m", -1)]
    assert "Loaded pretrained backbone facebook/opt-125m" in caplog.text
    assert torch.equal(model.bos.detach(), torch.from_numpy(embed[hf_import.BOS_IDS["opt"]]))
    drawn = tmain.build_model_and_trainer(cfg, _props(), torch.device("cpu"), pretrained=False,
                                          **TINY).model
    assert len(calls) == 1
    for li, (layer, drawn_layer) in enumerate(zip(model.lora.layers, drawn.lora.layers)):
        for name, ad in layer["attn"].items():
            assert torch.equal(ad.m, drawn_layer["attn"][name].m)
            w = state[f"layers.{li}.attn.{name}.weight"]
            assert not torch.equal(ad.m, w.norm(dim=1))

    want = bb.Backbone(bcfg)
    want.load_state_dict(state)
    if nf4:
        quantize_backbone(want, "nf4")
        assert isinstance(model.backbone.layers[1].mlp["fc2"], NF4Linear)
    _assert_state_equal(model.backbone.state_dict(), want.state_dict())


def test_other_widths_keep_random_init(monkeypatch, caplog):
    """A backbone built at other widths than the cached preset's (the
    ``FluidLLM.build`` overrides) keeps its draw, with the reason logged."""
    state, embed, bcfg = _tiny_opt_pretrained()
    monkeypatch.setattr(tmain, "load_pretrained", lambda *a: (state, embed, bcfg))
    caplog.set_level(logging.INFO, logger="fluid_llm_tpu_torch.main")
    model = FluidLLM.build(Config(**CFG), _props(), **dict(TINY, d_model=32, d_ff=64))
    model.init_weights(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert tmain.import_pretrained(model) is False
    assert "Pretrained facebook/opt-125m not imported: its widths (n_layers 2, d_model 64" \
        in caplog.text
    _assert_state_equal(model.state_dict(), before)


def test_moe_backbone_keeps_random_init(monkeypatch, caplog):
    monkeypatch.setattr(tmain, "load_pretrained", lambda *a: pytest.fail("MoE imported"))
    caplog.set_level(logging.INFO, logger="fluid_llm_tpu_torch.main")
    cfg = Config(**dict(CFG, use_lora=False), moe={"experts": 2, "top_k": 1})
    model = FluidLLM.build(cfg, _props(), **TINY)
    assert tmain.import_pretrained(model) is False
    assert "MoE backbone" in caplog.text


def test_continue_train_never_imports(tmp_path, monkeypatch):
    """``main`` imports once; ``continue_train`` restores into a template
    that reads no backbone (and ``inference`` never imports)."""
    runs = tmp_path / "runs"
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(dict(
        CFG, use_lora=False, freeze_llm=True, llm_layers=1, load_dir="synthetic:2",
        num_epochs=1, save_model_each=1, val_seq_len=SEQ_LEN, num_workers=0,
        checkpoint_save_path=str(runs))))
    calls = []
    monkeypatch.setattr(tmain, "load_pretrained", lambda *a: calls.append(a))
    assert tmain.main(["--config_path", str(cfg_path), "--device", "cpu"]) == 1
    assert calls == [("facebook/opt-125m", 1)]

    def forbidden(*a):
        raise AssertionError("continue_train read a pretrained backbone")

    monkeypatch.setattr(tmain, "load_pretrained", forbidden)
    monkeypatch.setattr(hf_import, "load_pretrained", forbidden)
    run = runs / "000"
    saved = yaml.safe_load((run / "config.yaml").read_text())
    (run / "config.yaml").write_text(yaml.safe_dump(dict(saved, num_epochs=2)))
    assert continue_train.main(["--checkpoint_dir", str(runs), "--device", "cpu"]) == 2
    mean = inference.main(["--checkpoint_dir", str(runs), "--device", "cpu",
                           "--seq_len", str(SEQ_LEN), "--pred_steps", "2"])
    assert np.isfinite(mean)
