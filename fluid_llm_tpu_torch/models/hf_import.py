"""HF checkpoint -> the port's backbone weights.

Counterpart of ``fluid_llm_tpu/models/hf_import.py``.  The reference loads
pretrained backbones via ``AutoModel.from_pretrained``
(``src/models/model.py:46-55``) and pulls the BOS token embedding for the
trainable BOS parameter (``model.py:62-73``).  The torch state dict is
converted into the JAX package's parameter tree (``convert_state_dict``,
numpy leaves, the same code) and from there into this package's names by
the one weight bridge, ``weights.from_jax_params``
(``backbone_state_dict``): every ``w`` is (in, out) in the tree and
transposed once by the bridge, so GPT-2's Conv1D weights, already
(in, out) in the file, are not transposed again.

``load_pretrained`` reads only the local HF cache (no download): the
snapshot ``refs/main`` names, whose files it reads itself
(``read_snapshot``, no ``transformers``): ``model.safetensors`` or
``pytorch_model.bin``, or their ``*.index.json`` shards.  It logs which
file it read, or why nothing was read, and returns None when the weights
are not there (random init then applies, as in the JAX package).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Optional

import numpy as np
import torch

from fluid_llm_tpu_torch.models.backbone import BackboneConfig, preset
from fluid_llm_tpu_torch.weights import from_jax_params

logger = logging.getLogger("fluid_llm_tpu_torch.hf_import")

Params = dict[str, Any]

# BOS token ids per family (tokenizer download not required)
BOS_IDS = {"opt": 2, "gpt2": 50256, "llama": 1}

# safetensors dtype names this reader takes (HF backbones are stored in these)
SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
# the weight files of a snapshot, in HF's order of preference
WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")


def _t(x) -> np.ndarray:
    """A stored tensor (f32, f16 or bf16) as f32 numpy."""
    return np.asarray(x.detach().cpu().float().numpy(), dtype=np.float32)


def convert_state_dict(sd: dict, cfg: BackboneConfig) -> tuple[Params, Optional[np.ndarray]]:
    """torch state dict -> (backbone params in the JAX layout, token table).

    The token table is None when absent from ``sd`` (dicts produced by
    ``tools.reference_ckpt.export_state_dict`` omit the frozen HF table the
    backbone never carries)."""
    if cfg.family == "opt":
        return _convert_opt(sd, cfg)
    if cfg.family == "gpt2":
        return _convert_gpt2(sd, cfg)
    if cfg.family == "llama":
        return _convert_llama(sd, cfg)
    raise ValueError(cfg.family)


def backbone_state_dict(sd: dict, cfg: BackboneConfig
                        ) -> tuple[dict[str, torch.Tensor], Optional[np.ndarray]]:
    """torch state dict -> (``Backbone.state_dict()`` of the port, token
    table): :func:`convert_state_dict` through ``weights.from_jax_params``."""
    params, embed_tokens = convert_state_dict(sd, cfg)
    return from_jax_params(params), embed_tokens


def _strip(sd: dict) -> dict:
    return {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}


def _convert_opt(sd: dict, cfg: BackboneConfig) -> tuple[Params, Optional[np.ndarray]]:
    sd = _strip(sd)
    p = "decoder."

    def lin(name):
        return {"w": _t(sd[f"{name}.weight"]).T, "b": _t(sd[f"{name}.bias"])}

    def ln(name):
        return {"scale": _t(sd[f"{name}.weight"]), "bias": _t(sd[f"{name}.bias"])}

    layers = []
    for i in range(cfg.n_layers):
        L = f"{p}layers.{i}."
        layers.append(
            {
                "ln1": ln(L + "self_attn_layer_norm"),
                "attn": {
                    "q": lin(L + "self_attn.q_proj"),
                    "k": lin(L + "self_attn.k_proj"),
                    "v": lin(L + "self_attn.v_proj"),
                    "o": lin(L + "self_attn.out_proj"),
                },
                "ln2": ln(L + "final_layer_norm"),
                "mlp": {"fc1": lin(L + "fc1"), "fc2": lin(L + "fc2")},
            }
        )
    params: Params = {
        "layers": layers,
        # OPT's learned positions already include the +2 offset rows: the
        # port's ``pos_embed`` is (max_pos + pos_offset, d)
        "pos_embed": _t(sd[p + "embed_positions.weight"]),
    }
    # OPT-350m: no final layer norm (do_layer_norm_before=False), and
    # project_in/project_out (no bias) around the decoder
    if cfg.final_ln:
        params["final_norm"] = ln(p + "final_layer_norm")
    if f"{p}project_in.weight" in sd:
        params["project_in"] = {"w": _t(sd[p + "project_in.weight"]).T}
        params["project_out"] = {"w": _t(sd[p + "project_out.weight"]).T}
    key = p + "embed_tokens.weight"
    return params, (_t(sd[key]) if key in sd else None)


def _convert_gpt2(sd: dict, cfg: BackboneConfig) -> tuple[Params, Optional[np.ndarray]]:
    sd = _strip(sd)

    def ln(name):
        return {"scale": _t(sd[f"{name}.weight"]), "bias": _t(sd[f"{name}.bias"])}

    layers = []
    for i in range(cfg.n_layers):
        L = f"h.{i}."
        # GPT-2 Conv1D stores (in, out): no transpose; c_attn packs q|k|v
        c_attn_w = _t(sd[L + "attn.c_attn.weight"])
        c_attn_b = _t(sd[L + "attn.c_attn.bias"])
        qw, kw, vw = np.split(c_attn_w, 3, axis=1)
        qb, kb, vb = np.split(c_attn_b, 3, axis=0)
        layers.append(
            {
                "ln1": ln(L + "ln_1"),
                "attn": {
                    "q": {"w": qw, "b": qb},
                    "k": {"w": kw, "b": kb},
                    "v": {"w": vw, "b": vb},
                    "o": {"w": _t(sd[L + "attn.c_proj.weight"]),
                          "b": _t(sd[L + "attn.c_proj.bias"])},
                },
                "ln2": ln(L + "ln_2"),
                "mlp": {
                    "fc1": {"w": _t(sd[L + "mlp.c_fc.weight"]), "b": _t(sd[L + "mlp.c_fc.bias"])},
                    "fc2": {"w": _t(sd[L + "mlp.c_proj.weight"]),
                            "b": _t(sd[L + "mlp.c_proj.bias"])},
                },
            }
        )
    params: Params = {
        "layers": layers,
        "final_norm": ln("ln_f"),
        "pos_embed": _t(sd["wpe.weight"]),
    }
    return params, (_t(sd["wte.weight"]) if "wte.weight" in sd else None)


def _convert_llama(sd: dict, cfg: BackboneConfig) -> tuple[Params, Optional[np.ndarray]]:
    # grouped-query k/v come out (d, n_kv_heads * head_dim) by their own
    # shape; the ``rotary_emb.inv_freq`` buffers are never read
    sd = _strip(sd)

    def lin(name):
        return {"w": _t(sd[f"{name}.weight"]).T}

    layers = []
    for i in range(cfg.n_layers):
        L = f"layers.{i}."
        layers.append(
            {
                "ln1": {"scale": _t(sd[L + "input_layernorm.weight"])},
                "attn": {
                    "q": lin(L + "self_attn.q_proj"),
                    "k": lin(L + "self_attn.k_proj"),
                    "v": lin(L + "self_attn.v_proj"),
                    "o": lin(L + "self_attn.o_proj"),
                },
                "ln2": {"scale": _t(sd[L + "post_attention_layernorm.weight"])},
                "mlp": {
                    "gate": lin(L + "mlp.gate_proj"),
                    "up": lin(L + "mlp.up_proj"),
                    "down": lin(L + "mlp.down_proj"),
                },
            }
        )
    params: Params = {"layers": layers, "final_norm": {"scale": _t(sd["norm.weight"])}}
    return params, (_t(sd["embed_tokens.weight"]) if "embed_tokens.weight" in sd else None)


# -- the local HF cache ---------------------------------------------------------


def hub_cache() -> str:
    """The HF hub cache folder: ``$HF_HUB_CACHE``, else ``$HF_HOME/hub``,
    else ``~/.cache/huggingface/hub``."""
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    if os.environ.get("HF_HOME"):
        return os.path.join(os.environ["HF_HOME"], "hub")
    return os.path.join(os.path.expanduser("~"), ".cache", "huggingface", "hub")


def snapshot_dir(name: str) -> str:
    """``<cache>/models--<org>--<name>/snapshots/<refs/main>``; raises
    ``FileNotFoundError`` when ``name`` is not cached."""
    repo = os.path.join(hub_cache(), "models--" + name.replace("/", "--"))
    with open(os.path.join(repo, "refs", "main")) as f:
        folder = os.path.join(repo, "snapshots", f.read().strip())
    if not os.path.isdir(folder):
        raise FileNotFoundError(f"refs/main of {repo} names no snapshot folder")
    return folder


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file: an 8-byte little-endian header length, a
    JSON header (dtype, shape and byte range of each tensor), raw bytes."""
    with open(path, "rb") as f:
        n_header = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n_header))
        data = bytearray(os.path.getsize(path) - 8 - n_header)
        if f.readinto(data) != len(data):
            raise ValueError(f"{path}: truncated")
    out = {}
    for key, meta in header.items():
        if key == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {key} of dtype {meta['dtype']}; this reader "
                             f"takes {sorted(SAFETENSORS_DTYPES)}")
        start, end = meta["data_offsets"]
        if end > len(data) or start > end:
            raise ValueError(f"{path}: tensor {key} lies outside the file")
        size = torch.empty((), dtype=dtype).element_size()
        flat = torch.frombuffer(data, dtype=dtype, count=(end - start) // size, offset=start) \
            if end > start else torch.empty(0, dtype=dtype)
        out[key] = flat.reshape(meta["shape"])
    return out


def _read_bin(path: str) -> dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


def read_snapshot(folder: str) -> tuple[dict[str, torch.Tensor], str]:
    """The state dict of the snapshot in ``folder`` with AutoModel's key
    names (``model.`` and ``transformer.`` prefixes stripped, ``lm_head.*``
    dropped); and the file or index it came from."""
    for fname in WEIGHT_FILES:
        single, index = os.path.join(folder, fname), os.path.join(folder, fname + ".index.json")
        if os.path.exists(single):
            files, source = [single], single
        elif os.path.exists(index):
            with open(index) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            files, source = [os.path.join(folder, s) for s in shards], index
        else:
            continue
        read = read_safetensors if fname.endswith(".safetensors") else _read_bin
        sd: dict[str, torch.Tensor] = {}
        for path in files:
            sd.update(read(path))
        out = {}
        for k, v in sd.items():
            for prefix in ("model.", "transformer."):
                if k.startswith(prefix):
                    k = k[len(prefix):]
                    break
            if not k.startswith("lm_head."):
                out[k] = v
        return out, source
    raise FileNotFoundError(f"no {' or '.join(WEIGHT_FILES)} (nor its index) in {folder}")


def load_pretrained(name: str, llm_layers: int = -1
                    ) -> Optional[tuple[dict[str, torch.Tensor], np.ndarray, BackboneConfig]]:
    """Read and convert a pretrained backbone from the local HF cache:
    (``Backbone.state_dict()``, token table, its config), or None with the
    reason logged when the weights are not there or cannot be read."""
    cfg = preset(name, llm_layers)
    # no network, as the JAX package sets it for any HF library in the process
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
    try:
        sd, source = read_snapshot(snapshot_dir(name))
    except (OSError, ValueError, KeyError, RuntimeError) as e:  # missing, or unreadable
        logger.info("Pretrained %s not read from %s: %s: %s", name, hub_cache(),
                    type(e).__name__, e)
        return None
    logger.info("Read pretrained %s from %s", name, source)
    state, embed_tokens = backbone_state_dict(sd, cfg)
    if embed_tokens is None:
        raise ValueError(f"pretrained {name} from {source} has no token table")
    return state, embed_tokens, cfg


def bos_embedding(embed_tokens: np.ndarray, cfg: BackboneConfig) -> torch.Tensor:
    """The pretrained BOS embedding that initialises the trainable BOS
    parameter (``model.py:70-73``)."""
    return torch.from_numpy(np.array(embed_tokens[BOS_IDS[cfg.family]], dtype=np.float32))
