"""LoRA / DoRA adapters and their merge into the backbone.

Counterpart of ``fluid_llm_tpu/models/lora.py``.  The reference wraps its
backbone with peft (``src/models/model.py:106-116``; DoRA r=16, alpha=64 on
the attention q/v projections).  Adapters are a tree parallel to the
backbone's layers, with the JAX layout (``A`` (in, r), ``B`` (r, out), ``m``
(out,)), so their keys and shapes equal the JAX pytree's:

    LoRA:  W_eff = W + (alpha/r) * A @ B
    DoRA:  W_eff = m * (W + dW) / ||W + dW||_col

On a tensor-parallel block (``parallel/tensor.py``) an adapter follows
its linear's split: on a column-parallel one ``A`` is whole and ``B`` and
DoRA's ``m`` hold this rank's output rows; on a row-parallel one ``A``
holds this rank's input rows, and DoRA's column norm sums the ranks'
squares.

``lora_linear`` is the unmerged forward (training, and the validation
rollout of a model in training); serving folds the adapters in with
``merge_lora``.  The base may be stored quantized (``llm_4bit_loading``:
nf4, ``fluid_llm_tpu/main.py:101-110``; or int8): it is dequantised at use
(``materialize_w``), and DoRA's ``m``, drawn before quantisation, comes
from the float weight.  On a MoE backbone only the attention projections
take adapters (``lora.py:58-66``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fluid_llm_tpu_torch.config import LoraConfig
from fluid_llm_tpu_torch.models.common import dropout, linear_weight
from fluid_llm_tpu_torch.ops.quant import is_quantized
from fluid_llm_tpu_torch.parallel import comm
from fluid_llm_tpu_torch.parallel import tensor as pt

# peft target-module names -> backbone (group, name)
_NAME_MAP = {
    "q_proj": ("attn", "q"),
    "k_proj": ("attn", "k"),
    "v_proj": ("attn", "v"),
    "o_proj": ("attn", "o"),
    "out_proj": ("attn", "o"),
    "fc1": ("mlp", "fc1"),
    "fc2": ("mlp", "fc2"),
    "gate_proj": ("mlp", "gate"),
    "up_proj": ("mlp", "up"),
    "down_proj": ("mlp", "down"),
}


def target_paths(cfg: LoraConfig) -> list[tuple[str, str]]:
    return [_NAME_MAP[t] for t in cfg.target_modules]


class LoraAdapter(nn.Module):
    def __init__(self, d_in: int, d_out: int, r: int, dora: bool):
        super().__init__()
        self.A = nn.Parameter(torch.empty(d_in, r))
        self.B = nn.Parameter(torch.empty(r, d_out))
        self.m = nn.Parameter(torch.empty(d_out)) if dora else None


class Lora(nn.Module):
    """Adapters for every layer of ``backbone`` (``init_lora``)."""

    def __init__(self, backbone: nn.Module, cfg: LoraConfig):
        super().__init__()
        self.cfg = cfg
        layers = []
        for layer in backbone.layers:
            groups: dict[str, nn.ModuleDict] = {}
            for group, name in target_paths(cfg):
                if group == "mlp" and hasattr(layer.mlp, "router"):
                    raise ValueError(
                        f"LoRA target {name!r} addresses the dense MLP, but this is a MoE "
                        "backbone (moe.experts > 0): adapt attention projections only, or "
                        "train the expert bank directly")
                lin = getattr(layer, group)[name]
                groups.setdefault(group, nn.ModuleDict())[name] = LoraAdapter(
                    lin.in_features, lin.out_features, cfg.r, cfg.use_dora
                )
            layers.append(nn.ModuleDict(groups))
        self.layers = nn.ModuleList(layers)

    @torch.no_grad()
    def reset_parameters(self, backbone: nn.Module, generator: torch.Generator) -> None:
        """peft's init: A ~ U(+-1/sqrt(in)), B = 0, m = ||W||_col (of the
        weight as stored: call before quantising the backbone, as the JAX
        package draws its adapters before ``main.py:103`` quantises)."""
        for layer, adapters in zip(backbone.layers, self.layers):
            for group, entries in adapters.items():
                for name, ad in entries.items():
                    bound = 1.0 / math.sqrt(ad.A.shape[0])
                    ad.A.uniform_(-bound, bound, generator=generator)
                    ad.B.zero_()
                    if ad.m is not None:
                        ad.m.copy_(linear_weight(getattr(layer, group)[name],
                                                 torch.float32).norm(dim=1))


def lora_linear(x: torch.Tensor, lin: nn.Module, ad: LoraAdapter, cfg: LoraConfig,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``lin`` applied to ``x`` with its adapter unmerged
    (``fluid_llm_tpu/models/lora.py:82-138``).

    Masters (base weight, ``A``/``B``/``m``) are cast to the activation dtype
    at use; a quantized base (``QuantLinear``, ``NF4Linear``) is
    dequantised to it, and DoRA's norm reads it dequantised in f32.  With ``generator`` (training) the adapter branch's input goes
    through ``lora_dropout``, as peft places it.  DoRA's column norm of
    ``W + s*A@B`` is taken in closed form, without materialising the
    update, and detached (the reference's weight-norm detach):
    ``||w_j||^2 + 2s <w_j, (AB)_j> + s^2 ||(AB)_j||^2``.
    """
    dtype = x.dtype
    scaling = cfg.lora_alpha / cfg.r
    x = pt.enter(lin, x)
    tp = pt.tp_of(lin)
    row = tp is not None and tp.kind == "row"
    feats = None
    if row:  # this rank's input features: A holds their rows
        n = ad.A.shape[0]
        feats = (tp.group.index * n, (tp.group.index + 1) * n, n * tp.group.size)
    x_drop = dropout(x, cfg.lora_dropout, generator, feats) if generator is not None else x
    y = F.linear(x, linear_weight(lin, dtype)) \
        + (x_drop @ ad.A.to(dtype)) @ ad.B.to(dtype) * scaling
    if ad.m is not None:
        with torch.no_grad():
            w32 = linear_weight(lin, torch.float32)  # (out, in): the JAX w transposed
            a32, b32 = ad.A.float(), ad.B.float()
            wn2 = (w32 * w32).sum(1)
            cross = ((w32 @ a32) * b32.T).sum(1)
            ab2 = torch.einsum("rs,rj,sj->j", a32.T @ a32, b32, b32)
            if row:  # each rank holds some input columns: sum their squares
                norm = torch.sqrt(comm.all_reduce(wn2 + 2.0 * scaling * cross
                                                  + scaling ** 2 * ab2, tp.group))
            else:
                norm = torch.sqrt(wn2 + 2.0 * scaling * cross + scaling ** 2 * ab2)
        y = y * (ad.m / norm).to(dtype)
    y = pt.leave(lin, y)
    if lin.bias is not None:
        y = y + lin.bias.to(dtype)
    return y


@torch.no_grad()
def merge_lora(backbone: nn.Module, lora: Lora) -> None:
    """Fold the adapters into the backbone's weights, in place.

    ``nn.Linear`` stores (out, in), so the JAX column norm over the input
    axis is a row norm here.  A quantized base becomes a float ``nn.Linear``
    of its dequantised weight plus the update (serving may quantize it
    again, ``FluidLLM.prepare_inference_params``).
    """
    scaling = lora.cfg.lora_alpha / lora.cfg.r
    for layer, adapters in zip(backbone.layers, lora.layers):
        for group, entries in adapters.items():
            for name, ad in entries.items():
                lin = getattr(layer, group)[name]
                w_eff = linear_weight(lin, torch.float32) \
                    + (ad.A.float() @ ad.B.float() * scaling).T
                if ad.m is not None:
                    tp = pt.tp_of(lin)
                    if tp is not None and tp.kind == "row":  # input columns cut
                        norm = torch.sqrt(comm.all_reduce((w_eff * w_eff).sum(1), tp.group))
                    else:
                        norm = w_eff.norm(dim=1)
                    w_eff = w_eff * (ad.m.float() / norm)[:, None]
                if is_quantized(lin):
                    dense = nn.Linear(w_eff.shape[1], w_eff.shape[0],
                                      bias=lin.bias is not None, device=w_eff.device)
                    if lin.bias is not None:
                        dense.bias.copy_(lin.bias)
                    dense.requires_grad_(False)
                    if pt.tp_of(lin) is not None:  # w_eff holds this rank's features
                        g = lin.tp.group
                        dense.tp = pt.TP(lin.tp.kind, g)
                        # its cut, for what gathers it whole (serving's quantization)
                        dense.shards = {"weight": ((0 if lin.tp.kind == "col" else 1,
                                                    "model", g),)}
                        if getattr(lin, "shards", {}).get("bias"):
                            dense.shards["bias"] = lin.shards["bias"]
                    getattr(layer, group)[name] = lin = dense
                for d, axis, g in getattr(lin, "shards", {}).get("weight", ()):
                    if axis == "fsdp":  # stored as this rank's fsdp chunk
                        w_eff = comm.chunk(w_eff, g, d)
                lin.weight.copy_(w_eff)
