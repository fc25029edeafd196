"""Reference (torch) checkpoint import/export: the migration path.

Counterpart of ``fluid_llm_tpu/tools/reference_ckpt.py``.  The reference
persists ``{'params': <cfg dict>, 'state_dict': model.state_dict(),
'optimizer', 'scheduler'}`` every ``save_model_each`` epochs
(``src/main.py:133-143``).  This module maps that ``state_dict`` onto the
port's ``FluidLLM`` and back, so a trained reference model comes over, or a
model trained here goes back to the reference stack:

    python -m fluid_llm_tpu_torch.tools.reference_ckpt step_200.pt \\
        --save_dir model_checkpoints/imported   # -> step_0/state.pt + config.yaml

The run folder it writes is the port's (``train/checkpoint.py``):
``inference --checkpoint_dir model_checkpoints`` rolls it out and
``continue_train`` trains on from it.

Key space of the reference model (``src/models/model.py:26-99``):

    backbone.*                        HF AutoModel (OPT / GPT-2 / LLaMA),
                                      optionally wrapped by peft
                                      (``model.py:106-116``) and/or
                                      ``torch.compile`` (``model.py:57-59``,
                                      adds ``_orig_mod.`` segments)
    BOS_embed                         trainable BOS vector (``model.py:62-73``)
    input_embeddings.patch_embeddings.encoder.*     MLP/CNN patch encoder
    input_embeddings.position_embeddings.*          learned 3-axis embeddings
                                      (rope variants carry no params)
    input_embeddings.LayerNorm.*      optional LN (``input_embeddings.py:26-29``)
    output_layer.decoder.*            MLP / CNN(1d) / MLPGNN patch decoder

The mapping runs through the JAX package's parameter tree, numpy leaves:
the import builds it and hands it to ``weights.from_jax_params``; the export
reads it from the model with ``weights.to_jax_params``.  Quantized storage,
MoE backbones and the stacked layout are not in the reference's key space
(nor in the JAX export) and are refused.

The torch optimizer/scheduler states are not imported: torch AdamW moments
are keyed by parameter position, not name, so resumed fine-tuning starts
with a fresh optimizer (the standard practice for checkpoint migration).
"""

from __future__ import annotations

import argparse
import re
import sys
from typing import Any, Optional

import numpy as np
import torch

from fluid_llm_tpu_torch.config import Config
from fluid_llm_tpu_torch.models.backbone import StackedLayers
from fluid_llm_tpu_torch.models.hf_import import convert_state_dict
from fluid_llm_tpu_torch.models.lora import _NAME_MAP
from fluid_llm_tpu_torch.ops.quant import is_quantized
from fluid_llm_tpu_torch.weights import from_jax_params, to_jax_params

Params = dict[str, Any]


def _np(x) -> np.ndarray:
    """torch tensor (or array) -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return np.asarray(x.detach().cpu().float().numpy(), dtype=np.float32)
    return np.asarray(x, dtype=np.float32)


def _tt(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))  # a copy, never a view


def _normalize_keys(sd: dict) -> dict:
    """Strip ``torch.compile`` wrapper segments (``_orig_mod.``) anywhere in
    the key path and drop known non-parameter buffers."""
    drop = (
        "rotary_emb.inv_freq",  # llama buffer
        "attn.masked_bias",  # gpt2 buffers
        "mesh_edges",  # MLPGNN fixed edge index (``GNN/decoders.py:214-215``)
    )
    out = {}
    for k, v in sd.items():
        k = k.replace("_orig_mod.", "")
        if any(k.endswith(d) for d in drop):
            continue
        # gpt2 causal-mask buffer ``h.{i}.attn.bias`` (real biases such as
        # ``attn.c_attn.bias`` stay)
        if re.search(r"\bh\.\d+\.attn\.bias$", k):
            continue
        out[k] = v
    return out


def _split_groups(sd: dict) -> dict[str, dict]:
    groups: dict[str, dict] = {"backbone": {}, "input_embeddings": {}, "output_layer": {}, "": {}}
    for k, v in sd.items():
        for prefix in ("backbone.", "input_embeddings.", "output_layer."):
            if k.startswith(prefix):
                groups[prefix[:-1]][k[len(prefix):]] = v
                break
        else:
            groups[""][k] = v
    return groups


# -- peft (LoRA / DoRA) ------------------------------------------------------


_LORA_RE = re.compile(
    r"^(?P<module>.+?)\.(?P<kind>lora_A|lora_B|lora_magnitude_vector)"
    r"(?:\.default)?\.weight$"
)


def _depeft(bsd: dict) -> tuple[dict, dict]:
    """Split a peft-wrapped backbone state dict into (base sd with plain HF
    names, adapters keyed by module path).  peft names: ``base_model.model.
    <module>.base_layer.weight`` + ``<module>.lora_A.default.weight`` etc.
    (the reference wraps with ``get_peft_model``, ``model.py:108-111``)."""
    adapters: dict[str, dict] = {}
    base: dict = {}
    for k, v in bsd.items():
        if k.startswith("base_model.model."):
            k = k[len("base_model.model."):]
        m = _LORA_RE.match(k)
        if m:
            entry = adapters.setdefault(m.group("module"), {})
            kind = m.group("kind")
            if kind == "lora_A":
                entry["A"] = _np(v).T  # peft (r, in) -> (in, r)
            elif kind == "lora_B":
                entry["B"] = _np(v).T  # peft (out, r) -> (r, out)
            else:
                entry["m"] = _np(v).reshape(-1)  # DoRA magnitude (out,)
            continue
        base[k.replace(".base_layer.", ".")] = v
    return base, adapters


def _lora_tree(adapters: dict, n_layers: int) -> Optional[Params]:
    """peft module paths -> the adapter tree (``models/lora.Lora`` layout)."""
    if not adapters:
        return None
    layers: list[Params] = [{} for _ in range(n_layers)]
    for module, leaf in adapters.items():
        m = re.search(r"layers\.(\d+)\.(?:self_attn|attn|mlp)?\.?(\w+)$", module)
        if m is None:
            raise ValueError(f"unrecognised peft target module {module!r}")
        li, tgt = int(m.group(1)), m.group(2)
        if tgt not in _NAME_MAP:
            raise ValueError(f"peft target {tgt!r} has no backbone mapping")
        group, name = _NAME_MAP[tgt]
        layers[li].setdefault(group, {})[name] = leaf
    return {"layers": layers}


# -- encoder / decoder / positional leaves ------------------------------------


def _import_linear_stack(sd: dict, prefix: str, n: int) -> list[dict]:
    """torch ``nn.Linear`` ModuleList (``MLP.py:27-47``) -> the mlp list."""
    return [
        {
            "w": _np(sd[f"{prefix}layers.{i}.weight"]).T,
            "b": _np(sd[f"{prefix}layers.{i}.bias"]),
        }
        for i in range(n)
    ]


def _export_linear_stack(layers: list[dict], prefix: str, out: dict) -> None:
    for i, leaf in enumerate(layers):
        out[f"{prefix}layers.{i}.weight"] = _tt(np.asarray(leaf["w"]).T)
        out[f"{prefix}layers.{i}.bias"] = _tt(leaf["b"])


def _import_conv_stack(sd: dict, prefix: str, n: int, conv1d: bool) -> list[dict]:
    """torch Conv2d (out,in,kh,kw) -> HWIO; Conv1d (out,in,k) -> WIO."""
    perm = (2, 1, 0) if conv1d else (2, 3, 1, 0)
    return [
        {
            "w": _np(sd[f"{prefix}layers.{i}.weight"]).transpose(perm),
            "b": _np(sd[f"{prefix}layers.{i}.bias"]),
        }
        for i in range(n)
    ]


def _export_conv_stack(layers: list[dict], prefix: str, out: dict, conv1d: bool) -> None:
    perm = (2, 1, 0) if conv1d else (3, 2, 0, 1)
    for i, leaf in enumerate(layers):
        out[f"{prefix}layers.{i}.weight"] = _tt(np.asarray(leaf["w"]).transpose(perm))
        out[f"{prefix}layers.{i}.bias"] = _tt(leaf["b"])


def _import_gatv2(sd: dict, prefix: str) -> Params:
    """PyG ``GATv2Conv`` leaves -> the grid GATv2 layout (``ops/grid_gnn``)."""
    att = _np(sd[f"{prefix}att"])
    p: Params = {
        "lin_l": {"w": _np(sd[f"{prefix}lin_l.weight"]).T},
        "lin_r": {"w": _np(sd[f"{prefix}lin_r.weight"]).T},
        # PyG att: (1, heads, out) -> (heads, out)
        "att": att.reshape(att.shape[-2:]),
    }
    if f"{prefix}lin_l.bias" in sd:
        p["lin_l"]["b"] = _np(sd[f"{prefix}lin_l.bias"])
        p["lin_r"]["b"] = _np(sd[f"{prefix}lin_r.bias"])
    if f"{prefix}bias" in sd:
        p["bias"] = _np(sd[f"{prefix}bias"])
    return p


def _export_gatv2(p: Params, prefix: str, out: dict) -> None:
    out[f"{prefix}lin_l.weight"] = _tt(np.asarray(p["lin_l"]["w"]).T)
    out[f"{prefix}lin_r.weight"] = _tt(np.asarray(p["lin_r"]["w"]).T)
    att = np.asarray(p["att"])
    out[f"{prefix}att"] = _tt(att.reshape(1, *att.shape))
    if "b" in p["lin_l"]:
        out[f"{prefix}lin_l.bias"] = _tt(p["lin_l"]["b"])
        out[f"{prefix}lin_r.bias"] = _tt(p["lin_r"]["b"])
    if "bias" in p:
        out[f"{prefix}bias"] = _tt(p["bias"])


# -- full-model import / export ----------------------------------------------


def import_state_dict(model, sd: dict) -> dict[str, torch.Tensor]:
    """Reference ``MultivariateTimeLLM.state_dict()`` -> the port's
    ``FluidLLM.state_dict()`` (``model.load_state_dict(..., strict=True)``
    takes it).

    ``model`` is a built :class:`~fluid_llm_tpu_torch.models.fluid_llm.
    FluidLLM` whose config matches the checkpoint (the ``params`` dict
    embedded in the reference save file is the same YAML surface), float
    and unrolled: quantize after the load (``FluidLLM.quantize_frozen``).
    A MoE backbone raises."""
    _check_reference_names(model)
    cfg = model.cfg
    groups = _split_groups(_normalize_keys(sd))

    base_sd, adapters = _depeft(groups["backbone"])
    try:
        backbone, _embed_tokens = convert_state_dict(base_sd, model.backbone_cfg)
    except KeyError as e:
        raise ValueError(
            f"backbone state dict is missing {e.args[0]!r}: the checkpoint does not match "
            f"the configured backbone ({cfg.llm_backbone!r}, {model.backbone_cfg.n_layers} "
            f"layers; set llm_backbone/llm_layers to the values the checkpoint was trained "
            f"with)"
        ) from e
    params: Params = {"backbone": backbone}

    lora = _lora_tree(adapters, model.backbone_cfg.n_layers)
    if lora is not None:
        params["lora"] = lora

    # input embeddings
    emb_sd, enc_cfg = groups["input_embeddings"], cfg.encoder_params
    enc_prefix = "patch_embeddings.encoder."
    if enc_cfg.type == "MLP":
        patch = {"mlp": _import_linear_stack(emb_sd, enc_prefix, enc_cfg.num_layers)}
    else:  # CNN (Conv2d over each patch, ``patch_encoder.py:17-19``)
        patch = {"cnn": _import_conv_stack(emb_sd, enc_prefix, enc_cfg.num_layers, conv1d=False)}
    input_emb: Params = {"patch": patch}
    if cfg.pos_embedding_params.pos_embedding_type == "pos":
        input_emb["pos"] = {
            "x": _np(emb_sd["position_embeddings.x_embeddings.weight"]),
            "y": _np(emb_sd["position_embeddings.y_embeddings.weight"]),
            "t": _np(emb_sd["position_embeddings.time_embeddings.weight"]),
        }
    if cfg.pos_embedding_params.in_emb_ln_eps is not None:
        input_emb["ln"] = {
            "scale": _np(emb_sd["LayerNorm.weight"]),
            "bias": _np(emb_sd["LayerNorm.bias"]),
        }
    params["input_emb"] = input_emb

    # patch decoder
    dec_sd, dec_cfg = groups["output_layer"], cfg.decoder_params
    if dec_cfg.type == "MLP":
        decoder: Params = {"mlp": _import_linear_stack(dec_sd, "decoder.", dec_cfg.num_layers)}
    elif dec_cfg.type == "CNN":
        decoder = {"cnn": _import_conv_stack(dec_sd, "decoder.", dec_cfg.num_layers, conv1d=True)}
    else:  # MLPGNN (``GNN/decoders.py:196-215``): 2-layer input MLP + GATv2 stack
        convs = [
            _import_gatv2(dec_sd, f"decoder.GNN.convs.{i}.")
            for i in range(dec_cfg.gnn_layers - 1)
        ]
        decoder = {
            "mlp": _import_linear_stack(dec_sd, "decoder.input_mlp.", 2),
            "gnn": {"convs": convs, "out": _import_gatv2(dec_sd, "decoder.GNN.out_conv.")},
        }
    params["decoder"] = decoder

    if cfg.use_bos_token:
        params["bos"] = _np(groups[""]["BOS_embed"]).reshape(-1)

    leftovers = [k for k in groups[""] if k != "BOS_embed"]
    if leftovers:
        raise ValueError(f"unmapped reference state-dict keys: {leftovers[:8]}")
    return from_jax_params(params)


def _check_reference_names(model) -> None:
    """Refuse what the reference's key space has no names for."""
    backbone = model.backbone
    if isinstance(backbone.layers, StackedLayers):
        raise ValueError("the stacked layer layout has no reference names: unstack first "
                         "(models.backbone.unstack_layers)")
    if model.backbone_cfg.moe_experts > 0:
        raise ValueError("a MoE backbone (moe.experts > 0) has no reference names")
    if any(is_quantized(m) for m in backbone.modules()):
        raise ValueError("a quantized backbone (nf4/int8 storage) has no reference names: "
                         "export the float weights")
    if any("qkv" in layer.attn for layer in backbone.layers):
        raise ValueError("packed q/k/v (FluidLLM.prepare_inference_params) has no reference "
                         "names: export the model as trained")


def export_state_dict(model, embed_tokens=None) -> dict[str, torch.Tensor]:
    """The port's model -> a reference-named torch ``state_dict`` (the
    exact inverse of :func:`import_state_dict`; peft layout when the model
    carries adapters), f32.

    The frozen HF token table the model does not carry is omitted unless
    passed as ``embed_tokens`` ((vocab, d), e.g. from
    ``hf_import.load_pretrained``).  The reference's own entry points load
    with ``strict=True`` (``continue_train.py:25``, ``inference.py:179``),
    which needs every key: pass ``embed_tokens`` for that, or load the dict
    reference-side with ``strict=False`` over a freshly built model.
    Raises on a stacked, MoE, quantized or packed-q/k/v backbone, and on
    GPT-2 adapters (peft adapts GPT-2's packed ``c_attn``)."""
    _check_reference_names(model)
    params = to_jax_params(model.state_dict())
    cfg = model.cfg
    bb_cfg = model.backbone_cfg
    out: dict = {}

    lora_layers = params.get("lora", {}).get("layers")
    targets = tuple(cfg.lora_config.target_modules) if lora_layers is not None else ()
    if lora_layers is not None and bb_cfg.family == "gpt2":
        # peft's GPT-2 adapters target the packed ``c_attn`` Conv1D: there is
        # no per-projection peft naming for q/k/v adapters (merge them first:
        # ``lora.merge_lora``)
        raise NotImplementedError(
            "GPT-2 LoRA adapters have no peft-compatible per-projection naming; merge "
            "adapters before export")
    for k, v in _export_backbone(params["backbone"], bb_cfg, embed_tokens).items():
        if lora_layers is not None:
            tgt = _peft_wrapped_name(k, targets)
            if tgt is not None:
                k = tgt
            k = f"base_model.model.{k}"
        out[f"backbone.{k}"] = v
    if lora_layers is not None:
        fam_prefix = {"opt": "decoder.", "llama": ""}[bb_cfg.family]
        hf_group = {
            ("attn", "q"): "self_attn.q_proj", ("attn", "k"): "self_attn.k_proj",
            ("attn", "v"): "self_attn.v_proj", ("attn", "o"): "self_attn.out_proj"
            if bb_cfg.family == "opt" else "self_attn.o_proj",
            ("mlp", "fc1"): "fc1", ("mlp", "fc2"): "fc2",
            ("mlp", "gate"): "mlp.gate_proj", ("mlp", "up"): "mlp.up_proj",
            ("mlp", "down"): "mlp.down_proj",
        }
        for li, entry in enumerate(lora_layers):
            for group, names in entry.items():
                for name, leaf in names.items():
                    mod = f"base_model.model.{fam_prefix}layers.{li}.{hf_group[(group, name)]}"
                    out[f"backbone.{mod}.lora_A.default.weight"] = _tt(np.asarray(leaf["A"]).T)
                    out[f"backbone.{mod}.lora_B.default.weight"] = _tt(np.asarray(leaf["B"]).T)
                    if "m" in leaf:
                        out[f"backbone.{mod}.lora_magnitude_vector.default.weight"] = \
                            _tt(leaf["m"])

    # input embeddings
    enc_cfg = cfg.encoder_params
    patch = params["input_emb"]["patch"]
    if enc_cfg.type == "MLP":
        _export_linear_stack(patch["mlp"], "input_embeddings.patch_embeddings.encoder.", out)
    else:
        _export_conv_stack(patch["cnn"], "input_embeddings.patch_embeddings.encoder.", out,
                           conv1d=False)
    if "pos" in params["input_emb"]:
        pos = params["input_emb"]["pos"]
        out["input_embeddings.position_embeddings.x_embeddings.weight"] = _tt(pos["x"])
        out["input_embeddings.position_embeddings.y_embeddings.weight"] = _tt(pos["y"])
        out["input_embeddings.position_embeddings.time_embeddings.weight"] = _tt(pos["t"])
    if "ln" in params["input_emb"]:
        out["input_embeddings.LayerNorm.weight"] = _tt(params["input_emb"]["ln"]["scale"])
        out["input_embeddings.LayerNorm.bias"] = _tt(params["input_emb"]["ln"]["bias"])

    # decoder
    dec_cfg, dec = cfg.decoder_params, params["decoder"]
    if dec_cfg.type == "MLP":
        _export_linear_stack(dec["mlp"], "output_layer.decoder.", out)
    elif dec_cfg.type == "CNN":
        _export_conv_stack(dec["cnn"], "output_layer.decoder.", out, conv1d=True)
    else:
        _export_linear_stack(dec["mlp"], "output_layer.decoder.input_mlp.", out)
        for i, conv in enumerate(dec["gnn"]["convs"]):
            _export_gatv2(conv, f"output_layer.decoder.GNN.convs.{i}.", out)
        _export_gatv2(dec["gnn"]["out"], "output_layer.decoder.GNN.out_conv.", out)

    if "bos" in params:
        out["BOS_embed"] = _tt(params["bos"])
    return out


def _peft_wrapped_name(k: str, targets: tuple) -> Optional[str]:
    """HF param key -> its peft ``.base_layer`` name if the module is one of
    the configured adapter targets (peft renames only wrapped Linears)."""
    m = re.match(r"^(.*\.(\w+))\.(weight|bias)$", k)
    if m is None or m.group(2) not in targets:
        return None
    return f"{m.group(1)}.base_layer.{m.group(3)}"


def _export_backbone(bb: Params, cfg, embed_tokens=None) -> dict:
    """The backbone tree -> HF-named torch tensors (inverse of
    ``hf_import._convert_{opt,gpt2,llama}``).  ``embed_tokens``: the frozen
    HF token table, emitted under its HF name when given; when None the key
    is omitted (a (4, d) placeholder would fail torch's size check under
    any ``strict``)."""
    out: dict = {}

    def lin(name, leaf, transpose=True):
        w = np.asarray(leaf["w"], dtype=np.float32)
        out[f"{name}.weight"] = _tt(w.T if transpose else w)
        if "b" in leaf:
            out[f"{name}.bias"] = _tt(leaf["b"])

    def ln(name, leaf):
        out[f"{name}.weight"] = _tt(leaf["scale"])
        if "bias" in leaf:
            out[f"{name}.bias"] = _tt(leaf["bias"])

    if cfg.family == "opt":
        p = "decoder."
        for i, L in enumerate(bb["layers"]):
            base = f"{p}layers.{i}."
            ln(base + "self_attn_layer_norm", L["ln1"])
            lin(base + "self_attn.q_proj", L["attn"]["q"])
            lin(base + "self_attn.k_proj", L["attn"]["k"])
            lin(base + "self_attn.v_proj", L["attn"]["v"])
            lin(base + "self_attn.out_proj", L["attn"]["o"])
            ln(base + "final_layer_norm", L["ln2"])
            lin(base + "fc1", L["mlp"]["fc1"])
            lin(base + "fc2", L["mlp"]["fc2"])
        out[p + "embed_positions.weight"] = _tt(bb["pos_embed"])
        if "final_norm" in bb:
            ln(p + "final_layer_norm", bb["final_norm"])
        if "project_in" in bb:
            lin(p + "project_in", bb["project_in"])
            lin(p + "project_out", bb["project_out"])
        if embed_tokens is not None:
            out[p + "embed_tokens.weight"] = _tt(embed_tokens)
    elif cfg.family == "gpt2":
        for i, L in enumerate(bb["layers"]):
            base = f"h.{i}."
            ln(base + "ln_1", L["ln1"])
            # GPT-2 Conv1D stores (in, out): concat q|k|v, no transpose
            a = L["attn"]
            out[base + "attn.c_attn.weight"] = _tt(
                np.concatenate([np.asarray(a[n]["w"], np.float32) for n in "qkv"], axis=1))
            out[base + "attn.c_attn.bias"] = _tt(
                np.concatenate([np.asarray(a[n]["b"], np.float32) for n in "qkv"]))
            lin(base + "attn.c_proj", a["o"], transpose=False)
            ln(base + "ln_2", L["ln2"])
            lin(base + "mlp.c_fc", L["mlp"]["fc1"], transpose=False)
            lin(base + "mlp.c_proj", L["mlp"]["fc2"], transpose=False)
        ln("ln_f", bb["final_norm"])
        out["wpe.weight"] = _tt(bb["pos_embed"])
        if embed_tokens is not None:
            out["wte.weight"] = _tt(embed_tokens)
    elif cfg.family == "llama":
        for i, L in enumerate(bb["layers"]):
            base = f"layers.{i}."
            ln(base + "input_layernorm", L["ln1"])
            lin(base + "self_attn.q_proj", L["attn"]["q"])
            lin(base + "self_attn.k_proj", L["attn"]["k"])
            lin(base + "self_attn.v_proj", L["attn"]["v"])
            lin(base + "self_attn.o_proj", L["attn"]["o"])
            ln(base + "post_attention_layernorm", L["ln2"])
            lin(base + "mlp.gate_proj", L["mlp"]["gate"])
            lin(base + "mlp.up_proj", L["mlp"]["up"])
            lin(base + "mlp.down_proj", L["mlp"]["down"])
        ln("norm", bb["final_norm"])
        if embed_tokens is not None:
            out["embed_tokens.weight"] = _tt(embed_tokens)
    else:
        raise ValueError(cfg.family)
    return out


# -- file-level entry points --------------------------------------------------


def load_reference_checkpoint(path: str, cfg: Optional[Config] = None) -> tuple[dict, Config]:
    """A reference ``.pt`` save -> (its state dict, Config).

    When ``cfg`` is None the config dict embedded in the save file
    (``checkpoint['params']``, ``src/main.py:137``) builds it: the YAML
    surfaces are the same.  The file is read with ``weights_only=True``:
    tensors, containers and plain values, never arbitrary objects."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in payload:
        sd = payload["state_dict"]
        if cfg is None and "params" in payload:
            cfg = Config.from_dict(dict(payload["params"]))
    else:
        sd = payload  # a bare state_dict
    if cfg is None:
        raise ValueError("no config embedded in the checkpoint; pass --config")
    return sd, cfg


def main(argv=None) -> str:
    """Import a reference ``.pt`` into a run folder of the port: its
    ``config.yaml`` and ``step_0`` (the imported weights, a fresh optimizer,
    epoch 0; the frozen backbone quantized to nf4 after the import with
    ``llm_4bit_loading``, as ``main``'s template).  A file conversion on
    the host: nothing is computed.  Returns the checkpoint's path."""
    from fluid_llm_tpu_torch.data import get_dataset
    from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
    from fluid_llm_tpu_torch.train.checkpoint import save_checkpoint
    from fluid_llm_tpu_torch.train.trainer import Trainer

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("checkpoint", help="reference .pt save file")
    parser.add_argument("--config", default=None, help="YAML config (default: the config "
                        "dict embedded in the checkpoint)")
    parser.add_argument("--save_dir", required=True,
                        help="output run folder (step_0/state.pt + config.yaml)")
    args = parser.parse_args(argv)

    cfg = Config.from_yaml(args.config) if args.config else None
    sd, cfg = load_reference_checkpoint(args.checkpoint, cfg)
    ds = get_dataset(cfg.replace(seq_len=cfg.autoreg_seq_len), mode="train")
    model = FluidLLM.build(cfg, ds.ds_props())
    model.load_state_dict(import_state_dict(model, sd))
    model.quantize_frozen()
    trainer = Trainer(model)
    path = save_checkpoint(args.save_dir, 0, model, trainer.opt, 0, cfg)
    print(f"imported {args.checkpoint} -> {path}")
    return path


if __name__ == "__main__":
    main(sys.argv[1:])
