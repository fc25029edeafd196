"""Decoder-only transformer backbone (OPT / GPT-2 / LLaMA layouts).

Counterpart of ``fluid_llm_tpu/models/backbone.py``.  The reference feeds
pre-computed patch embeddings via ``inputs_embeds`` (token embeddings nulled,
``src/models/model.py:102-104``), so the backbone takes embeddings and has
no token table.

Fidelity notes, as in the JAX package:
- OPT/GPT-2 add their own learned 1-D position embedding on top of
  ``inputs_embeds``, with OPT's offset-2 indexing; LLaMA rotates q and k
  (``_rope``, split halves) and has no position table.
- Positions are ``cumsum(valid) - 1`` (clipped at 0), which equals
  ``arange(L)`` for dense inputs and stays right for the rollout's
  right-aligned window, whose invalid frames sit at the front.
- Pre-LN (default) or post-LN (OPT-350m), with ``project_in``/``project_out``
  where the embedding width differs (OPT-350m).  LLaMA: RMSNorm, SwiGLU,
  no biases, grouped-query attention (``n_kv_heads``).

Attention, with ``kernels`` set and where the kernels take the shape:
without gradients (rollout, inference) it runs the exact-window kernel
(``ops/exact_attention.py``); with gradients and ``flash_attention``
(training) it runs ``ops/flash_attention.FlashAttention``, whose backward
is the dq and dk/dv kernels.  Otherwise the plain twin, under autograd.
``attn_impl="short"`` (``backbone.py:1433-1445``) sends every attention,
with or without gradients, through ``ops/short_attention.ShortAttention``
(its kernel forward, a recomputed plain backward); on CUDA a length or head
width the kernel refuses raises, never falls back.  Rope'd heads (and
grouped k/v heads, repeated) go to each in the packed ``(bs, L, H*hd)``
layout.  ``decode_slice`` computes the final block for one token range
only (``_final_block_sliced``, plain PyTorch attention).

Every projection goes through ``models.common.linear``: a linear stored as
int8 (``ops/quant.quantize_backbone``, serving) runs the int8-matmul kernel
of ``ops/quant_matmul.py`` on the card, in the mode it was stored with.

Training (``backbone.py:769-948``): LoRA/DoRA adapters are applied unmerged
(``models/lora.lora_linear``) on their target projections, and dropout
draws from a ``torch.Generator`` at the HF placement: the embedding stream,
after the attention out-projection and after the MLP.  With ``remat``
(``parallel.remat``, ``backbone.py:902``) each full block under autograd
is rematerialised (``torch.utils.checkpoint``): its activations are
recomputed in the backward, with the same dropout masks (the generator's
state is replayed).  ``pack_qkv_params`` and ``cast_matmul_params`` are
inference-only.

Streaming (``backbone.py:1032-1402``, rope backbones): ``apply_streaming``
runs new tokens through every block once against the slab KV cache of
``init_streaming_cache``; its attention is ``ops/decode_attention.py``.

The stacked-layer layout (``backbone.py:308-352``): ``stack_layers``
replaces the layer list by one :class:`StackedLayers` whose parameters
carry a leading ``n_layers`` axis, under the JAX leaf names.  ``forward``
then reads layer ``li``'s weights as the slices ``w[li]`` (the JAX
``_block_stacked`` with ``kernel_ok=False``); ``apply_streaming`` runs every
float linear through the indexed-linear kernel (``ops/indexed_linear.py``)
with the layer index on the device, as the JAX stacked scan does.  Layers
quantized the same way stack too: their int8 or nf4 storage gains the
leading axis, and layer ``li`` reads its slice through
``models.common.linear`` (int8: the int8-matmul kernel on the slice; nf4
dequantised), JAX ``_stacked_linear``'s quantized branch (:650-651).

Mixture of experts (``moe_experts > 0``, ``backbone.py:188-211,443-574``):
every block's MLP is a :class:`MoEMLP`, a float router and expert banks
with a leading ``E`` axis, run in the dense-dispatch formulation
(:func:`moe_route`, :func:`moe_mlp`): routing in f32, capacity ``C`` per
expert, invalid tokens never routed, the Switch balance loss as each
block's ``aux`` (``forward``'s ``moe_aux`` collects them).  There is no
kernel in it: the dispatch, the expert FFNs and the combine are einsums,
as in the JAX package.  A MoE final block runs whole (``decode_slice``
refuses it: capacity couples the tokens of a layer), and MoE layers stay
unrolled.  Ring attention and tensor parallelism come later.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fluid_llm_tpu_torch.models.common import dropout, linear, linear_weight
from fluid_llm_tpu_torch.models.lora import lora_linear
from fluid_llm_tpu_torch.ops import decode_attention as da
from fluid_llm_tpu_torch.ops import exact_attention as xa
from fluid_llm_tpu_torch.ops import flash_attention as fa
from fluid_llm_tpu_torch.ops import indexed_linear as il
from fluid_llm_tpu_torch.ops import short_attention as sa
from fluid_llm_tpu_torch.ops.quant import is_quantized, quantized_layer, stack_quantized


ATTN_IMPLS = ("auto", "short")


@dataclass(frozen=True)
class BackboneConfig:
    family: str  # "opt" | "gpt2" | "llama"
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_kv_heads: Optional[int] = None  # grouped-query attention; None -> n_heads
    max_pos: int = 2048
    # OPT-350m: embeddings at ``word_embed_proj_dim`` with project_in/out,
    # post-LN blocks and no final norm (HF ``OPTConfig``)
    d_embed: Optional[int] = None
    pre_ln: bool = True
    final_ln: bool = True
    act: str = "relu"  # "relu" | "gelu_new" | "gelu" | "silu" (LLaMA's SwiGLU)
    norm: str = "layernorm"  # "layernorm" | "rmsnorm"
    pos: str = "learned"  # "learned" | "rope"
    pos_offset: int = 0  # OPT uses 2
    rope_theta: float = 10000.0
    ln_eps: float = 1e-5
    dropout: float = 0.1  # training only
    dtype: torch.dtype = torch.float32  # activation dtype
    # training attention through the flash kernels (``cfg.flash_attention``)
    flash_attention: bool = False
    # "auto" (the choice above) or "short" (``ops/short_attention.py``)
    attn_impl: str = "auto"
    # rematerialise each full block under autograd (``parallel.remat``)
    remat: bool = False
    # mixture of experts (``backbone.py:66-79``): 0 is the dense MLP
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_router: str = "topk"  # "topk" (Switch/GShard) | "expert_choice"

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r}: one of {ATTN_IMPLS}")

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim

    @property
    def embed_dim(self) -> int:
        """The width of ``inputs_embeds`` and of the backbone output."""
        return self.d_embed or self.d_model

    def replace(self, **kw) -> "BackboneConfig":
        return dataclasses.replace(self, **kw)


PRESETS: dict[str, BackboneConfig] = {
    "facebook/opt-125m": BackboneConfig(
        family="opt", n_layers=12, d_model=768, n_heads=12, d_ff=3072,
        act="relu", pos_offset=2, max_pos=2048,
    ),
    "facebook/opt-350m": BackboneConfig(
        family="opt", n_layers=24, d_model=1024, n_heads=16, d_ff=4096,
        act="relu", pos_offset=2, max_pos=2048,
        d_embed=512, pre_ln=False, final_ln=False,
    ),
    "facebook/opt-2.7b": BackboneConfig(
        family="opt", n_layers=32, d_model=2560, n_heads=32, d_ff=10240,
        act="relu", pos_offset=2, max_pos=2048,
    ),
    "openai-community/gpt2": BackboneConfig(
        family="gpt2", n_layers=12, d_model=768, n_heads=12, d_ff=3072,
        act="gelu_new", max_pos=1024,
    ),
    "gpt2": BackboneConfig(
        family="gpt2", n_layers=12, d_model=768, n_heads=12, d_ff=3072,
        act="gelu_new", max_pos=1024,
    ),
    "huggyllama/llama-7b": BackboneConfig(
        family="llama", n_layers=32, d_model=4096, n_heads=32, d_ff=11008,
        act="silu", norm="rmsnorm", pos="rope", ln_eps=1e-6, max_pos=2048, dropout=0.0,
    ),
    # the JAX package's own LLaMA-style backbones (no HF counterpart): rotary
    # positions make them servable by the streaming KV-cache rollout
    "fluid/llama-125m": BackboneConfig(
        family="llama", n_layers=12, d_model=768, n_heads=12, d_ff=2048,
        act="silu", norm="rmsnorm", pos="rope", ln_eps=1e-6, max_pos=32768, dropout=0.0,
    ),
    "fluid/llama-350m": BackboneConfig(
        family="llama", n_layers=24, d_model=1024, n_heads=16, d_ff=2816,
        act="silu", norm="rmsnorm", pos="rope", ln_eps=1e-6, max_pos=32768, dropout=0.0,
    ),
}


def preset(name: str, llm_layers: int = -1, **overrides) -> BackboneConfig:
    """Resolve a backbone name + optional layer truncation (``model.py:37-39``)."""
    if name not in PRESETS:
        raise ValueError(f"Unknown or not yet ported backbone {name!r}; known: {sorted(PRESETS)}")
    cfg = PRESETS[name]
    if llm_layers > cfg.n_layers:
        raise ValueError(
            f"Requested number of layers ({llm_layers}) is greater than the "
            f"model's ({cfg.n_layers})!"
        )
    if llm_layers > 0:
        cfg = cfg.replace(n_layers=llm_layers)
    return cfg.replace(**overrides) if overrides else cfg


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "relu":
        return F.relu(x)
    if name == "gelu_new":
        return F.gelu(x, approximate="tanh")
    if name == "gelu":
        return F.gelu(x)
    raise ValueError(name)


def _make_norm(cfg: BackboneConfig, d: int) -> nn.Module:
    if cfg.norm == "rmsnorm":
        return nn.RMSNorm(d, eps=cfg.ln_eps)
    return nn.LayerNorm(d, eps=cfg.ln_eps)


def _norm(x: torch.Tensor, ln, cfg: BackboneConfig) -> torch.Tensor:
    """``cfg.norm`` (LayerNorm or RMSNorm, eps ``cfg.ln_eps``) computed in
    f32, returned in the activation dtype (``backbone.py:383-393``).  ``ln``
    holds the norm's ``weight`` (and a LayerNorm's ``bias``): an
    ``nn.LayerNorm``/``nn.RMSNorm``, or one layer of a :class:`StackedNorm`."""
    shape = x.shape[-1:]
    w = ln.weight.float()  # bf16 under ``frozen_bf16``, computed in f32 as in JAX
    if cfg.norm == "rmsnorm":
        out = F.rms_norm(x.float(), shape, w, cfg.ln_eps)
    else:
        out = F.layer_norm(x.float(), shape, w, ln.bias.float(), cfg.ln_eps)
    return out.to(x.dtype)


def make_masks(valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(positions, allowed) from a (bs, L) bool validity mask.

    positions = cumsum(valid) - 1, clipped at 0 (HF OPT's attention-mask
    position ids); allowed (bs, 1, L, L) = causal AND key-valid, with the
    diagonal forced on so invalid-query rows keep one finite logit.
    """
    L = valid.shape[1]
    positions = (valid.long().cumsum(-1) - 1).clamp_min(0)
    causal = torch.ones(L, L, dtype=torch.bool, device=valid.device).tril()
    eye = torch.eye(L, dtype=torch.bool, device=valid.device)
    allowed = (causal[None] & valid[:, None, :]) | eye[None]
    return positions, allowed[:, None]


def rope_tables(positions: torch.Tensor, cfg: BackboneConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) factors of the rotary embedding for (bs, L) positions,
    each (bs, L, 1, hd) f32, laid out for :func:`apply_rope`.

    The angles are computed in f32 from the integer positions (a streamed
    rollout reaches ~15k tokens: bf16 would lose them).  Computed once per
    forward and shared by every layer."""
    hd = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=positions.device) / hd))
    angles = positions[..., None].float() * inv_freq  # (bs, L, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([cos, cos], -1)[:, :, None], torch.cat([-sin, sin], -1)[:, :, None]


def apply_rope(x: torch.Tensor, tables, n_heads: int) -> torch.Tensor:
    """LLaMA rotary embedding (``backbone.py:576-589``, split halves, not
    interleaved) of packed heads ``(bs, L, n_heads*hd)``, computed in f32:
    ``[x1 cos - x2 sin, x2 cos + x1 sin]``.  Returns the packed layout."""
    cos, sin = tables
    bs, L, D = x.shape
    xf = x.reshape(bs, L, n_heads, D // n_heads).float()
    half = xf.shape[-1] // 2
    out = xf * cos + torch.cat([xf[..., half:], xf[..., :half]], -1) * sin
    return out.to(x.dtype).reshape(bs, L, D)


def _repeat_kv(t: torch.Tensor, cfg: BackboneConfig) -> torch.Tensor:
    """Grouped k/v heads repeated to the query heads, packed layout
    (``jnp.repeat(k, n_heads // kv_heads, axis=2)``)."""
    if cfg.kv_heads == cfg.n_heads:
        return t
    bs, L, _ = t.shape
    t = t.reshape(bs, L, cfg.kv_heads, cfg.head_dim)
    return t.repeat_interleave(cfg.n_heads // cfg.kv_heads, dim=2).reshape(bs, L, cfg.d_model)


def _attention(q, k, v, allowed, dtype) -> torch.Tensor:
    """Masked attention, f32 scores and softmax, probabilities in ``dtype``.

    q: (bs, Lq, H, hd); k/v: (bs, Lk, H, hd); allowed: broadcastable to
    (bs, H, Lq, Lk).  Port of ``backbone._attention_xla``.
    """
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    logits = torch.where(allowed, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _masked_attend(allowed: torch.Tensor, dtype: torch.dtype):
    """An attention of the packed layout under an explicit mask ``allowed``
    (broadcastable to (bs, H, L, L)): plain PyTorch, as the JAX
    ``allowed_override`` forces its XLA path."""
    def attend(q, k, v, valid_i32, n_heads: int, head_dim: int) -> torch.Tensor:
        bs, L, D = q.shape
        shape = (bs, L, n_heads, head_dim)
        out = _attention(q.reshape(shape), k.reshape(shape), v.reshape(shape), allowed, dtype)
        return out.reshape(bs, L, D)
    return attend


# --------------------------------------------------------------------------
# mixture of experts (``backbone.py:188-211, 443-574``)
# --------------------------------------------------------------------------


class ExpertBank(nn.Module):
    """The linears of every expert at one place of a MoE MLP: ``weight``
    ``(E, out, in)`` (the ``nn.Linear`` orientation; the JAX leaf ``w`` is
    ``(E, in, out)``), ``bias`` ``(E, out)`` or None."""

    def __init__(self, n_experts: int, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(n_experts, out_features, in_features, **kw))
        self.register_parameter(
            "bias", nn.Parameter(torch.empty(n_experts, out_features, **kw)) if bias else None)


class MoEMLP(nn.Module):
    """One MoE MLP (``_moe_init``): ``router`` a bias-free ``(d -> E)``
    linear, kept f32 (routing computes in f32), and ``experts`` the banks:
    ``fc1``/``fc2`` with biases (OPT, GPT-2) or LLaMA's ``gate``/``up``/
    ``down``.  A bank may be stored int8 (``ops/quant.QuantLinear`` with a
    leading ``E`` axis)."""

    def __init__(self, cfg: "BackboneConfig"):
        super().__init__()
        E, d, ff = cfg.moe_experts, cfg.d_model, cfg.d_ff
        self.router = nn.Linear(d, E, bias=False)
        if cfg.family == "llama":
            banks = {"gate": ExpertBank(E, d, ff, bias=False), "up": ExpertBank(E, d, ff, bias=False),
                     "down": ExpertBank(E, ff, d, bias=False)}
        else:
            banks = {"fc1": ExpertBank(E, d, ff), "fc2": ExpertBank(E, ff, d)}
        self.experts = nn.ModuleDict(banks)


class Routing(NamedTuple):
    """:func:`moe_route`'s result: ``dispatch`` and ``combine`` (bs, L, E,
    C) f32 and the balance loss ``aux`` (a scalar)."""

    dispatch: torch.Tensor
    combine: torch.Tensor
    aux: torch.Tensor


def moe_capacity(cfg: "BackboneConfig", L: int, capacity_tokens: Optional[int] = None) -> int:
    """Slots per expert: ``ceil(cf * top_k * (capacity_tokens or L) / E)``,
    at least 1, and for expert_choice at most ``L``."""
    C = max(1, math.ceil(cfg.moe_capacity_factor * cfg.moe_top_k * (capacity_tokens or L)
                         / cfg.moe_experts))
    return min(C, L) if cfg.moe_router == "expert_choice" else C


def moe_route(logits: torch.Tensor, cfg: "BackboneConfig", valid: Optional[torch.Tensor] = None,
              capacity_tokens: Optional[int] = None) -> Routing:
    """The routing of ``_moe_mlp`` from f32 router logits (bs, L, E): their
    softmax in f32, then :func:`moe_dispatch`."""
    return moe_dispatch(torch.softmax(logits.float(), dim=-1), cfg, valid, capacity_tokens)


def moe_dispatch(probs: torch.Tensor, cfg: "BackboneConfig", valid: Optional[torch.Tensor] = None,
                 capacity_tokens: Optional[int] = None) -> Routing:
    """Dispatch and combine from the router's f32 probabilities (bs, L, E).

    Probabilities are zeroed on invalid tokens (``valid`` (bs, L) bool),
    which so take no slot, displace no token and stay out of the balance
    statistics.  topk: ``top_k`` passes of argmax (the first
    maximum, as ``jnp.argmax``), each slot placed at the token's cumsum
    position in its expert plus the slots earlier choices took, kept below
    ``C``; the gate is the raw probability at top-1 and renormalised by
    ``max(sum p, 1e-9)`` above; aux is Switch's ``E * sum_e frac_e *
    pbar_e`` over valid tokens.  Every choice's slots are added into one
    (bs, L, E, C) tensor pair by one ``scatter_add``, built once a layer,
    equal to the JAX sum of one-hots (a slot is taken by one choice; where
    extreme logits make argmax pick a taken expert twice, two terms add in
    either order to the same value).
    expert_choice: each expert takes its top-C tokens by a stable
    descending sort (ties in token order, as ``lax.top_k``; ``torch.topk``
    promises no order for ties on CUDA); aux is 0.  In practice only
    zero-probability (invalid) tokens tie, once an expert's C exceeds the
    valid tokens; their gate is 0, so the output cannot depend on which
    of them fills the slot."""
    bs, L, E = probs.shape
    C = moe_capacity(cfg, L, capacity_tokens)
    valid_f = None
    if valid is not None:
        valid_f = valid.float()[..., None]  # (bs, L, 1)
        probs = probs * valid_f
    if cfg.moe_router == "expert_choice":
        order = torch.sort(probs.transpose(1, 2), dim=-1, descending=True, stable=True)
        gates, idx = order.values[..., :C], order.indices[..., :C]  # (bs, E, C)
        dispatch = F.one_hot(idx, L).float().permute(0, 3, 1, 2)  # (bs, L, E, C)
        combine = dispatch * gates[:, None]
        return Routing(dispatch, combine, probs.new_zeros(()))

    sel_oh, sel_p = [], []
    remaining = probs
    for _ in range(cfg.moe_top_k):
        oh = F.one_hot(remaining.argmax(-1), E).float()  # (bs, L, E)
        if valid_f is not None:
            oh = oh * valid_f
        sel_oh.append(oh)
        sel_p.append((probs * oh).sum(-1))
        remaining = remaining * (1.0 - oh)
    denom = torch.clamp(sum(sel_p), min=1e-9) if cfg.moe_top_k > 1 else 1.0
    slots, keeps, gates = [], [], []
    prev = probs.new_zeros(bs, 1, E)  # slots taken by earlier choices
    for oh, p in zip(sel_oh, sel_p):
        pos = oh.cumsum(1) - oh + prev
        prev = prev + oh.sum(1, keepdim=True)
        keep = oh * (pos < C)
        slots.append(pos.clamp(max=C - 1).long())
        keeps.append(keep)
        gates.append(keep * (p / denom)[..., None])
    # every choice's slots added at once: (bs, L, E, top_k) into (bs, L, E, C)
    slot = torch.stack(slots, -1)
    dispatch = probs.new_zeros(bs, L, E, C).scatter_add(-1, slot, torch.stack(keeps, -1))
    combine = probs.new_zeros(bs, L, E, C).scatter_add(-1, slot, torch.stack(gates, -1))
    if valid_f is None:
        frac, pbar = sel_oh[0].mean(1), probs.mean(1)
    else:
        n_valid = valid_f.sum(1).clamp(min=1.0)  # (bs, 1)
        frac, pbar = sel_oh[0].sum(1) / n_valid, probs.sum(1) / n_valid
    aux = (E * (frac * pbar).sum(-1)).mean()
    return Routing(dispatch, combine, aux)


def moe_mlp(h: torch.Tensor, mlp: MoEMLP, cfg: "BackboneConfig",
            valid: Optional[torch.Tensor] = None,
            capacity_tokens: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``_moe_mlp``: (bs, L, d) -> ((bs, L, d) in h's dtype, aux).

    The router's logits in f32 (:func:`moe_route`); dispatch and combine
    cast to the activation dtype before their einsums; the expert FFNs as
    batched einsums over the ``(E, out, in)`` banks (an int8 bank
    dequantised, ``scale[..., None]``).  A dropped token (past its expert's
    capacity) gets no MLP contribution: the residual carries it.
    ``capacity_tokens``: the token count ``C`` is sized by, where padding
    must not inflate it."""
    dt = h.dtype
    logits = F.linear(h.float(), mlp.router.weight.float())
    r = moe_route(logits, cfg, valid, capacity_tokens)
    xin = torch.einsum("bld,blec->ebcd", h, r.dispatch.to(dt))
    ex = mlp.experts

    def ffn(x, name):
        y = torch.einsum("ebci,eoi->ebco", x, linear_weight(ex[name], dt))
        b = ex[name].bias
        return y if b is None else y + b.to(dt)[:, None, None, :]

    if "gate" in ex:
        out = ffn(F.silu(ffn(xin, "gate")) * ffn(xin, "up"), "down")
    else:
        out = ffn(_act(ffn(xin, "fc1"), cfg.act), "fc2")
    out = torch.einsum("ebcd,blec->bld", out, r.combine.to(out.dtype))
    return out.to(dt), r.aux


class _LayerOps:
    """The computations of one transformer block, over the parameters its
    subclass holds: ``ln1``/``ln2`` and the ``attn``/``mlp`` maps of
    linears (``attn.q``..., ``attn.qkv`` once packed; ``mlp.fc1``/``fc2``,
    or LLaMA's ``mlp.gate``/``up``/``down``).  :class:`Block` holds its own;
    :class:`LayerView` reads one layer of a :class:`StackedLayers`."""

    def apply_linear(self, h, lin, kernels: bool = True, cols: Optional[slice] = None):
        """``lin`` applied to ``h`` (``models.common.linear``)."""
        return linear(h, lin, kernels, cols)

    def proj(self, h, group: str, name: str, adapters=None, lora_cfg=None, generator=None,
             kernels: bool = True):
        """``group.name`` applied to ``h``, through its adapter if it has one
        (unmerged; adapter dropout when ``generator`` is given).  ``kernels``:
        an int8 projection through the int8-matmul kernel (False: its twin)."""
        lin = getattr(self, group)[name]
        ad = adapters[group][name] if adapters is not None and group in adapters \
            and name in adapters[group] else None
        if ad is None:
            return self.apply_linear(h, lin, kernels)
        return lora_linear(h, lin, ad, lora_cfg, generator)

    def qkv(self, h: torch.Tensor, cfg: BackboneConfig, adapters=None, lora_cfg=None,
            generator=None, rope=None, kernels: bool = True):
        """q, k, v of ``h``, q and k rotated when ``rope`` tables are given:
        column slices of the fused projection when packed (whose adjacent q
        and k columns rotate in one pass)."""
        if "qkv" in self.attn:
            if adapters is not None and "attn" in adapters \
                    and any(n in adapters["attn"] for n in "qkv"):
                raise ValueError("packed qkv weights cannot apply q/k/v adapters: merge them "
                                 "first (FluidLLM.prepare_inference_params)")
            d, kv = cfg.d_model, cfg.kv_dim
            qkv = self.apply_linear(h, self.attn["qkv"], kernels)
            qk = qkv[..., :d + kv]
            if rope is not None:
                qk = apply_rope(qk, rope, cfg.n_heads + cfg.kv_heads)
            return qk[..., :d], qk[..., d:], qkv[..., d + kv:]
        q, k, v = (self.proj(h, "attn", n, adapters, lora_cfg, generator, kernels)
                   for n in ("q", "k", "v"))
        if rope is not None:
            q, k = apply_rope(q, rope, cfg.n_heads), apply_rope(k, rope, cfg.kv_heads)
        return q, k, v

    def mlp_out(self, h, cfg: BackboneConfig, lin) -> torch.Tensor:
        """The MLP branch: LLaMA's SwiGLU ``down(silu(gate h) * up h)``, or
        ``fc2(act(fc1 h))``; ``lin(h, group, name)`` applies a projection."""
        if "gate" in self.mlp:
            return lin(F.silu(lin(h, "mlp", "gate")) * lin(h, "mlp", "up"), "mlp", "down")
        return lin(_act(lin(h, "mlp", "fc1"), cfg.act), "mlp", "fc2")

    def forward(self, x, cfg: BackboneConfig, valid_i32, attend, adapters=None, lora_cfg=None,
                generator=None, rope=None, kernels: bool = True):
        """``(x, aux)``: the block's output and, for a MoE block, its balance
        loss (None for a dense one; an output, not a side effect, so that a
        rematerialised block recomputes it).  ``generator``: training
        (adapter and residual dropout draw from it); None runs without
        dropout.  ``rope``: the (cos, sin) tables of a rotary backbone."""
        lin = lambda h, group, name: self.proj(h, group, name, adapters, lora_cfg, generator,
                                               kernels)
        drop = (lambda h: dropout(h, cfg.dropout, generator)) if generator is not None \
            else (lambda h: h)
        h = _norm(x, self.ln1, cfg) if cfg.pre_ln else x
        q, k, v = self.qkv(h, cfg, adapters, lora_cfg, generator, rope, kernels)
        k, v = _repeat_kv(k, cfg), _repeat_kv(v, cfg)
        x = x + drop(lin(attend(q, k, v, valid_i32, cfg.n_heads, cfg.head_dim), "attn", "o"))
        if not cfg.pre_ln:
            x = _norm(x, self.ln1, cfg)
        h = _norm(x, self.ln2, cfg) if cfg.pre_ln else x
        aux = None
        if isinstance(self.mlp, MoEMLP):
            h, aux = moe_mlp(h, self.mlp, cfg, valid_i32.bool())
        else:
            h = self.mlp_out(h, cfg, lin)
        x = x + drop(h)
        if not cfg.pre_ln:
            x = _norm(x, self.ln2, cfg)
        return x, aux


def rematerialised(fn, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """``fn(x)`` under ``torch.utils.checkpoint``: only ``x`` is kept, the
    rest recomputed in the backward.  Dropout drawn from ``generator`` draws
    the same masks again: the recompute starts from the generator's state
    of the first call and leaves it as it found it."""
    if generator is None:
        return checkpoint(fn, x, use_reentrant=False)
    first = generator.get_state()
    calls = []

    def run(x):
        if not calls:
            calls.append(1)
            return fn(x)
        now = generator.get_state()
        generator.set_state(first)
        try:
            return fn(x)
        finally:
            generator.set_state(now)

    return checkpoint(run, x, use_reentrant=False)


class Block(_LayerOps, nn.Module):
    """One transformer block; ``attn``/``mlp`` are ModuleDicts so the keys
    follow the JAX pytree."""

    def __init__(self, cfg: BackboneConfig):
        super().__init__()
        d, ff, kv = cfg.d_model, cfg.d_ff, cfg.kv_dim
        bias = cfg.family != "llama"
        self.ln1 = _make_norm(cfg, d)
        self.attn = nn.ModuleDict({"q": nn.Linear(d, d, bias=bias), "k": nn.Linear(d, kv, bias=bias),
                                   "v": nn.Linear(d, kv, bias=bias), "o": nn.Linear(d, d, bias=bias)})
        self.ln2 = _make_norm(cfg, d)
        if cfg.moe_experts > 0:
            self.mlp = MoEMLP(cfg)
        elif cfg.family == "llama":
            self.mlp = nn.ModuleDict({"gate": nn.Linear(d, ff, bias=False),
                                      "up": nn.Linear(d, ff, bias=False),
                                      "down": nn.Linear(ff, d, bias=False)})
        else:
            self.mlp = nn.ModuleDict({"fc1": nn.Linear(d, ff), "fc2": nn.Linear(ff, d)})


# --------------------------------------------------------------------------
# the stacked-layer layout (``backbone.py:308-352``): one module whose
# parameters carry a leading ``n_layers`` axis
# --------------------------------------------------------------------------


def _param(t: torch.Tensor, like: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=like.requires_grad)


def _stack_place(mods: list[nn.Module]) -> nn.Module:
    """The linears of one place in every layer, stacked: float ones into a
    :class:`StackedLinear`, quantized ones (all stored alike) into their
    own class with a leading ``n_layers`` axis (``ops/quant.stack_quantized``)."""
    return stack_quantized(mods) if is_quantized(mods[0]) else StackedLinear(mods)


def _unstack_place(stacked: nn.Module, li: int) -> nn.Module:
    return quantized_layer(stacked, li, clone=True) if is_quantized(stacked) \
        else stacked.unstack(li)


class _Stacked(nn.Module):
    """One place of the block in every layer: ``weight`` and ``bias`` (or
    None) with a leading ``n_layers`` axis."""

    def __init__(self, mods: list[nn.Module]):
        super().__init__()
        self.weight = _param(torch.stack([m.weight for m in mods]), mods[0].weight)
        bias = getattr(mods[0], "bias", None)  # an RMSNorm has none
        self.register_parameter(
            "bias", None if bias is None else _param(torch.stack([m.bias for m in mods]), bias))

    def _fill(self, mod: nn.Module, li: int) -> nn.Module:
        """``mod`` (made on the meta device) given layer ``li``'s parameters."""
        mod.weight = _param(self.weight[li].clone(), self.weight)
        if self.bias is not None:
            mod.bias = _param(self.bias[li].clone(), self.bias)
        return mod


class StackedLinear(_Stacked):
    """The linears of every layer at one place of the block: ``weight``
    ``(n_layers, N, K)`` (the ``nn.Linear`` orientation), ``bias``
    ``(n_layers, N)`` or None."""

    def unstack(self, li: int) -> nn.Linear:
        n_out, n_in = self.weight.shape[1:]
        with torch.device("meta"):
            lin = nn.Linear(n_in, n_out, bias=self.bias is not None)
        return self._fill(lin, li)


class StackedNorm(_Stacked):
    """The norms of every layer at one place of the block: ``weight`` (and a
    LayerNorm's ``bias``) ``(n_layers, d)``."""

    def unstack(self, li: int, cfg: BackboneConfig) -> nn.Module:
        with torch.device("meta"):
            norm = _make_norm(cfg, self.weight.shape[1])
        return self._fill(norm, li)


class _Slice:
    """Layer ``li`` of a :class:`StackedLinear` or :class:`StackedNorm`, as
    ``models.common.linear`` and :func:`_norm` read an ``nn.Linear`` or a
    norm: ``weight`` and ``bias`` are the views ``[li]``; ``stacked`` the
    whole ``(weight, bias)``, which the indexed linear reads."""

    __slots__ = ("weight", "bias", "stacked")

    def __init__(self, stacked: _Stacked, li: int):
        self.stacked = (stacked.weight, stacked.bias)
        self.weight = stacked.weight[li]
        self.bias = None if stacked.bias is None else stacked.bias[li]


class StackedLayers(nn.Module):
    """Every block's parameters with a leading ``n_layers`` axis, under the
    JAX leaf names (``ln1``, ``attn.qkv``, ``mlp.gate``, ...), and
    ``index``: ``arange(n_layers)`` int32, kept on the parameters' device,
    whose elements are the layer indices the indexed-linear kernel reads.

    ``views[False][li]`` computes layer ``li`` from slices of the
    parameters, ``views[True][li]`` through the indexed-linear kernel at
    ``index[li]`` (:class:`LayerView`).  They are made once, without
    gradient (the layout is inference-only): they share the parameters'
    storage, so in-place writes (``load_state_dict``) reach them, and are
    made anew after ``Module.to`` and its kin, which may move it."""

    def __init__(self, layers: list[Block]):
        super().__init__()
        self.ln1 = StackedNorm([m.ln1 for m in layers])
        self.attn = nn.ModuleDict({n: _stack_place([m.attn[n] for m in layers])
                                   for n in layers[0].attn})
        self.ln2 = StackedNorm([m.ln2 for m in layers])
        self.mlp = nn.ModuleDict({n: _stack_place([m.mlp[n] for m in layers])
                                  for n in layers[0].mlp})
        self.register_buffer("index", torch.arange(len(layers), dtype=torch.int32,
                                                   device=self.ln1.weight.device),
                             persistent=False)
        self._make_views()

    def _make_views(self) -> None:
        with torch.no_grad():
            self.views = {indexed: [LayerView(self, li, self.index[li] if indexed else None)
                                    for li in range(len(self))] for indexed in (False, True)}

    def _apply(self, fn, *args, **kwargs):
        out = super()._apply(fn, *args, **kwargs)
        self._make_views()
        return out

    def __len__(self) -> int:
        return self.index.shape[0]

    def unstack(self, cfg: BackboneConfig) -> list[Block]:
        blocks = []
        for li in range(len(self)):
            with torch.device("meta"):
                block = Block(cfg)
            block.ln1, block.ln2 = self.ln1.unstack(li, cfg), self.ln2.unstack(li, cfg)
            block.attn = nn.ModuleDict({n: _unstack_place(m, li) for n, m in self.attn.items()})
            block.mlp = nn.ModuleDict({n: _unstack_place(m, li) for n, m in self.mlp.items()})
            blocks.append(block)
        return blocks


class LayerView(_LayerOps):
    """One layer of a :class:`StackedLayers`, computed as a :class:`Block`.

    ``index`` None: the linears read the slices ``w[li]``, ``b[li]`` (JAX
    ``_block_stacked``'s ``kernel_ok=False``: the rollout's stacked
    forward).  ``index`` a device int32 scalar: every linear goes through
    ``ops/indexed_linear.indexed_linear`` (its twin when ``kernels`` is
    False) at that index, as the JAX stacked streaming scan's
    ``_stacked_linear``.  Norms read their slice either way, and so do
    quantized linears (views ``[li]`` of the stacked storage, through
    ``models.common.linear``: int8 the int8-matmul kernel, nf4 dequantised,
    JAX ``_stacked_linear``'s quantized branch)."""

    def __init__(self, stacked: StackedLayers, li: int, index: Optional[torch.Tensor] = None):
        self.index = index
        self.ln1, self.ln2 = _Slice(stacked.ln1, li), _Slice(stacked.ln2, li)
        self.attn = {n: self._place(m, li) for n, m in stacked.attn.items()}
        self.mlp = {n: self._place(m, li) for n, m in stacked.mlp.items()}

    @staticmethod
    def _place(m: nn.Module, li: int):
        return quantized_layer(m, li) if is_quantized(m) else _Slice(m, li)

    def apply_linear(self, h, lin, kernels: bool = True, cols: Optional[slice] = None):
        if self.index is None or is_quantized(lin):
            return linear(h, lin, kernels, cols)
        if cols is not None:
            raise ValueError("indexed stacked linears compute every output column")
        fn = il.indexed_linear if kernels else il.indexed_linear_ref
        return fn(h, *lin.stacked, self.index)

    def __call__(self, *args, **kwargs) -> torch.Tensor:
        return self.forward(*args, **kwargs)


class Backbone(nn.Module):
    def __init__(self, cfg: BackboneConfig):
        super().__init__()
        if cfg.family not in ("opt", "gpt2", "llama"):
            raise ValueError(f"backbone family {cfg.family!r}: only opt/gpt2/llama are ported")
        self.cfg = cfg
        d = cfg.d_model
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.final_norm = _make_norm(cfg, d) if cfg.final_ln else None
        if cfg.d_embed is not None and cfg.d_embed != d:
            self.project_in = nn.Linear(cfg.d_embed, d, bias=False)
            self.project_out = nn.Linear(d, cfg.d_embed, bias=False)
        else:
            self.project_in = self.project_out = None
        self.pos_embed = nn.Parameter(torch.empty(cfg.max_pos + cfg.pos_offset, d)) \
            if cfg.pos == "learned" else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX init: N(0, 0.02) weights (the MoE router and expert banks
        too) and positions, zero biases, unit norms."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, ExpertBank)):
                mod.weight.normal_(0.0, 0.02, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.LayerNorm, nn.RMSNorm)):
                mod.reset_parameters()
        if self.pos_embed is not None:
            self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(
        self,
        inputs_embeds: torch.Tensor,
        valid: Optional[torch.Tensor] = None,
        *,
        decode_slice: Optional[tuple[int, int]] = None,
        kernels: bool = True,
        lora=None,
        generator: Optional[torch.Generator] = None,
        remat: Optional[bool] = None,
        moe_aux: Optional[list] = None,
        positions: Optional[torch.Tensor] = None,
        allowed: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """(bs, L, d) -> (bs, L, d), or (bs, length, d) with ``decode_slice``.

        valid: optional (bs, L) bool token validity (True = real token).
        decode_slice: optional (start, length): the final block computes
        queries and FFN for that token range only -- exact under causal
        attention, since later layers' other outputs are never read.
        kernels: run attention through the CUDA kernels where they take the
        shape (CPU tensors use the plain twins either way); False selects
        the plain twin explicitly.
        lora: optional ``models.lora.Lora`` applied unmerged.
        generator: training mode: dropout (embedding stream, residual
        branches, adapter inputs) draws from it; None means no dropout.
        remat: rematerialise each full block under autograd (None: the
        config's ``remat``).
        moe_aux: a list that each MoE block appends its balance loss to.
        positions, allowed: replace the cumsum positions (bs, L) and the
        causal mask (broadcastable to (bs, H, L, L)), as the JAX
        ``positions_override``/``allowed_override`` (the streaming oracle's
        banded mask); a mask sends attention through plain PyTorch.
        """
        cfg = self.cfg
        bs, L = inputs_embeds.shape[:2]
        x = inputs_embeds.to(cfg.dtype)
        if valid is None:
            valid = torch.ones(bs, L, dtype=torch.bool, device=x.device)
        mask_positions, mask = make_masks(valid)
        positions = mask_positions if positions is None else positions
        if self.project_in is not None:
            x = linear(x, self.project_in, kernels)
        if self.pos_embed is not None:
            x = x + self.pos_embed[positions + cfg.pos_offset].to(cfg.dtype)
        rope = rope_tables(positions, cfg) if cfg.pos == "rope" else None
        if generator is not None:
            x = dropout(x, cfg.dropout, generator)

        attend = self._attend(L, kernels, x.device) if allowed is None \
            else _masked_attend(allowed, cfg.dtype)
        allowed = mask if allowed is None else allowed
        if isinstance(self.layers, StackedLayers):
            # the stacked layout is made for inference, adapters merged
            # (``backbone.py:907-915``)
            if lora is not None:
                raise ValueError("stacked layer params cannot apply a LoRA tree: merge the "
                                 "adapters before stack_layers")
            if generator is not None:
                raise ValueError("stacked layer params are inference-only (no dropout)")
            if torch.is_grad_enabled() and any(p.requires_grad for p in self.layers.parameters()):
                raise ValueError("stacked layer params are inference-only: no gradient reaches "
                                 "them (run under torch.no_grad, or unstack_layers first)")
            layers = self.layers.views[False]
        else:
            layers = list(self.layers)
        valid_i32 = valid.to(torch.int32).contiguous()
        adapters = lora.layers if lora is not None else [None] * cfg.n_layers
        lora_cfg = lora.cfg if lora is not None else None
        n_full = cfg.n_layers - (1 if decode_slice is not None else 0)
        remat = (cfg.remat if remat is None else remat) and torch.is_grad_enabled()
        for layer, ad in zip(layers[:n_full], adapters):
            block = lambda x, layer=layer, ad=ad: layer(x, cfg, valid_i32, attend, ad, lora_cfg,
                                                        generator, rope, kernels)
            x, aux = rematerialised(block, x, generator) if remat else block(x)
            if aux is not None and moe_aux is not None:
                moe_aux.append(aux)
        if decode_slice is not None:
            x = self._final_block_sliced(x, layers[-1], allowed, rope, decode_slice, adapters[-1],
                                         lora_cfg, kernels)
        return self._out(x, kernels)

    def _attend(self, L: int, kernels: bool, device: torch.device):
        """The attention of every full block at length ``L``."""
        cfg = self.cfg
        if cfg.attn_impl == "short":
            if not kernels:
                return sa.short_attention_ref
            if device.type == "cuda" and not sa.supported(L, cfg.head_dim):
                raise ValueError(f"attn_impl='short': the kernel does not take L {L} with heads "
                                 f"of {cfg.head_dim} (L <= {sa.MAX_TOKENS}, head_dim in "
                                 f"{sa.HEAD_DIMS})")
            return sa.short_attention
        if torch.is_grad_enabled():
            # the exact-window kernel has no backward; training attention is
            # the flash Function (its twins on CPU tensors) or the plain twin
            use_flash = kernels and cfg.flash_attention and fa.supported(cfg.head_dim, cfg.dtype)
            return fa.flash_attention if use_flash else xa.causal_attention_ref
        use_kernel = kernels and xa.supported(cfg.head_dim, cfg.dtype)
        return xa.causal_attention if use_kernel else xa.causal_attention_ref

    def _out(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        if self.final_norm is not None:
            x = _norm(x, self.final_norm, self.cfg)
        if self.project_out is not None:
            x = linear(x, self.project_out, kernels)
        return x

    def _final_block_sliced(self, x, layer: _LayerOps, allowed, rope, decode_slice,
                            adapters=None, lora_cfg=None, kernels: bool = True) -> torch.Tensor:
        """Final block (``layer``) for queries ``start:start+length`` only
        (exact under causal attention; ``backbone.py:951-1029``), adapters
        unmerged if given.  Rope rotates the q slice at its own positions
        and k over the whole window.  Attention is plain PyTorch, no
        dropout; weights are read only through ``layer.apply_linear`` (int8
        ones through their kernel).  A MoE block raises: its expert
        capacity couples the tokens of the layer, so a slice would route
        differently (``backbone.py:1013-1020``); it runs whole."""
        if isinstance(layer.mlp, MoEMLP):
            raise NotImplementedError("decode_slice is not exact for MoE blocks (capacity couples "
                                      "tokens within a layer): run the final block whole")
        cfg = self.cfg
        lin = lambda h, group, name: layer.proj(h, group, name, adapters, lora_cfg,
                                                kernels=kernels)
        start, ln = decode_slice
        bs, L, d = x.shape
        H, hd = cfg.n_heads, cfg.head_dim

        h = _norm(x, layer.ln1, cfg) if cfg.pre_ln else x
        x_s = x[:, start:start + ln]
        h_q = h[:, start:start + ln]
        if "qkv" in layer.attn:
            # packed weights: q over the slice, fused k|v over the full window
            q = layer.apply_linear(h_q, layer.attn["qkv"], kernels, cols=slice(0, d))
            kv = layer.apply_linear(h, layer.attn["qkv"], kernels, cols=slice(d, None))
            k, v = kv[..., :cfg.kv_dim], kv[..., cfg.kv_dim:]
        else:
            q = lin(h_q, "attn", "q")
            k = lin(h, "attn", "k")
            v = lin(h, "attn", "v")
        if rope is not None:
            q = apply_rope(q, tuple(t[:, start:start + ln] for t in rope), H)
            k = apply_rope(k, rope, cfg.kv_heads)
        q = q.reshape(bs, ln, H, hd)
        k = _repeat_kv(k, cfg).reshape(bs, L, H, hd)
        v = _repeat_kv(v, cfg).reshape(bs, L, H, hd)

        attn_out = _attention(q, k, v, allowed[:, :, start:start + ln], cfg.dtype)
        x_s = x_s + lin(attn_out.reshape(bs, ln, d), "attn", "o")
        if not cfg.pre_ln:
            x_s = _norm(x_s, layer.ln1, cfg)

        h2 = _norm(x_s, layer.ln2, cfg) if cfg.pre_ln else x_s
        x_s = x_s + layer.mlp_out(h2, cfg, lin)
        if not cfg.pre_ln:
            x_s = _norm(x_s, layer.ln2, cfg)
        return x_s


@torch.no_grad()
def stack_layers(backbone: Backbone) -> None:
    """The layer list becomes one :class:`StackedLayers`, in place
    (``backbone.py:308-336``).  Exact: layer ``li`` reads the same weights.

    A no-op on a stacked backbone, on MoE layers (their banks already lead
    with ``E``; JAX :324-328) and on layers that differ in structure (names,
    types, int8 matmul modes, shapes or dtypes of their parameters and
    buffers: e.g. qkv packed in some only, or quantized differently), which
    keep the list, as JAX's treedef check.  Layers quantized alike stack
    their storage."""
    layers = backbone.layers
    if isinstance(layers, StackedLayers) or any(isinstance(m.mlp, MoEMLP) for m in layers):
        return

    def structure(layer: Block):
        return ([(n, type(m), getattr(m, "mode", None)) for n, m in layer.named_modules()],
                [(n, p.shape, p.dtype, p.device) for n, p in layer.named_parameters()],
                [(n, b.shape, b.dtype, b.device) for n, b in layer.named_buffers()])

    if any(structure(m) != structure(layers[0]) for m in layers[1:]):
        return
    backbone.layers = StackedLayers(list(layers))


@torch.no_grad()
def unstack_layers(backbone: Backbone) -> None:
    """Inverse of :func:`stack_layers`, in place: the list of ``nn.Linear``
    (or quantized) layers back, bit for bit (``backbone.py:339-352``).  A
    no-op on a list."""
    if isinstance(backbone.layers, StackedLayers):
        backbone.layers = nn.ModuleList(backbone.layers.unstack(backbone.cfg))


@torch.no_grad()
def pack_qkv_params(backbone: Backbone) -> None:
    """Fuse each layer's q/k/v projections into one ``qkv`` linear of
    ``d + 2 kv_dim`` outputs, in place (with biases where the layer has
    them).

    Exact (same math, one matmul instead of three).  Apply AFTER
    ``merge_lora``: adapters target the unpacked names.  Quantized q/k/v
    stay unpacked (``backbone.py:368``).
    """
    for layer in backbone.layers:
        attn = layer.attn
        if "qkv" in attn or not all(isinstance(attn[n], nn.Linear) for n in ("q", "k", "v")):
            continue
        parts = [attn[n] for n in ("q", "k", "v")]
        bias = parts[0].bias is not None
        qkv = nn.Linear(parts[0].in_features, sum(p.out_features for p in parts), bias=bias,
                        device=parts[0].weight.device, dtype=parts[0].weight.dtype)
        qkv.weight.copy_(torch.cat([p.weight for p in parts], dim=0))
        if bias:
            qkv.bias.copy_(torch.cat([p.bias for p in parts]))
        for n in ("q", "k", "v"):
            del attn[n]
        attn["qkv"] = qkv


@torch.no_grad()
def cast_matmul_params(backbone: Backbone, dtype: torch.dtype) -> None:
    """Store the layers' matmul weights in the activation dtype, in place.

    Exact for inference: every matmul casts its weight to the activation
    dtype anyway.  Norms and the position table stay f32 (computed in f32 /
    cast at use, as in the JAX package).  Quantized linears are left as they
    are (``Module.to`` would cast their f32 scales; ``backbone.py:284``).
    MoE expert banks are cast; the router stays f32 (routing computes in
    f32; ``backbone.py:282``).
    """
    lins = [backbone.project_in, backbone.project_out]
    for layer in backbone.layers:
        mlp = layer.mlp.experts if isinstance(layer.mlp, MoEMLP) else layer.mlp
        lins += list(layer.attn.values()) + list(mlp.values())
    for lin in lins:
        if isinstance(lin, (nn.Linear, ExpertBank)):
            lin.to(dtype)


# --------------------------------------------------------------------------
# streaming KV-cache decode (``backbone.py:1032-1402``): each frame is
# encoded once against a cache of the pinned sinks and the last R frames
# --------------------------------------------------------------------------


def _slab_tokens(frame_tokens: int, n_sink: int) -> int:
    """Tokens per cache slab: the frame size (and the sink count, which
    shares the buffer) rounded up to 16."""
    return max(-(-frame_tokens // 16) * 16, -(-max(n_sink, 1) // 16) * 16)


def init_streaming_cache(cfg: BackboneConfig, bs: int, n_sink: int, n_frames: int,
                         frame_tokens: int, device=None) -> dict[str, torch.Tensor]:
    """The slab KV cache of ``backbone.py:1045-1090``, in its layout.

    ``k``/``v``: ``(L, bs, n_frames + 1, P̂, kvh*hd)`` zeros in the
    activation dtype, ``P̂ = _slab_tokens(frame_tokens, n_sink)``.  Slots
    ``0..n_frames-1`` are the frame ring, one whole frame per slab (rows
    past the frame stay zero and are masked); slot ``n_frames`` holds the
    pinned attention sinks.  Heads are folded on the last dim (head ``h``
    at columns ``[h*hd, (h+1)*hd)``), so a slab reads as rows of the
    packed projection output.  ``sink_pos`` holds each sink token's
    absolute position, ``ring_pos`` each ring slot's first-token position
    (-1: never written); int32.
    """
    pp = _slab_tokens(frame_tokens, n_sink)
    if n_sink > pp:
        raise ValueError(f"n_sink={n_sink} exceeds the slab size {pp}")
    shape = (cfg.n_layers, bs, n_frames + 1, pp, cfg.kv_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "sink_pos": torch.full((n_sink,), -1, dtype=torch.int32, device=device),
        "ring_pos": torch.full((n_frames,), -1, dtype=torch.int32, device=device),
    }


def slab_key_positions(cache: dict[str, torch.Tensor], frame_tokens: int) -> torch.Tensor:
    """Every cached key's absolute position, in slab order (ring slots, then
    the sink slot): (slots*P̂,) int32, INT32_MAX for unwritten slots and
    slab pad rows.  Every resident token precedes (or is) each new query,
    so causality, also among the new tokens, is ``key_pos <= q_pos``
    (``backbone.py:1199-1216``); frames' tokens are consecutive, so a ring
    slot's keys are its first-token position plus the row."""
    big = torch.iinfo(torch.int32).max
    ring_pos, sink_pos = cache["ring_pos"], cache["sink_pos"]
    pp = cache["k"].shape[3]
    row = torch.arange(pp, dtype=torch.int32, device=ring_pos.device)
    ring_kp = torch.where((ring_pos >= 0)[:, None] & (row < frame_tokens)[None, :],
                          ring_pos[:, None] + row[None, :], big)
    sink_kp = torch.full((pp,), big, dtype=torch.int32, device=ring_pos.device)
    sink_kp[:sink_pos.shape[0]] = torch.where(sink_pos >= 0, sink_pos, big)
    return torch.cat([ring_kp.reshape(-1), sink_kp])


def _attention_slabs(q, k_slabs, v_slabs, allowed, cfg: BackboneConfig) -> torch.Tensor:
    """Plain attention over one layer's slab cache (``backbone.py:1093-1115``).

    q: (bs, Ln, H, hd); slabs: (bs, slots, P̂, kvh*hd); allowed:
    (1, 1, Ln, slots*P̂) -- pad rows and unwritten slots already masked off
    by the key-position row.  Returns (bs, Ln, H, hd).
    """
    bs = q.shape[0]
    slots, pp = k_slabs.shape[1:3]
    kk = _repeat_kv(k_slabs.reshape(bs, slots * pp, cfg.kv_dim), cfg)
    vv = _repeat_kv(v_slabs.reshape(bs, slots * pp, cfg.kv_dim), cfg)
    shape = (bs, slots * pp, cfg.n_heads, cfg.head_dim)
    return _attention(q, kk.reshape(shape), vv.reshape(shape), allowed, cfg.dtype)


@torch.no_grad()
def apply_streaming(
    backbone: Backbone,
    x_new: torch.Tensor,
    new_positions: torch.Tensor,
    cache: dict[str, torch.Tensor],
    write_slot: int,
    *,
    prefill: bool = False,
    frame_tokens: Optional[int] = None,
    kernels: bool = True,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Run every block over ``x_new`` (bs, Ln, d) against the cached K/V
    (``backbone.py:1118-1393``; stacked layers: every linear through
    ``ops/indexed_linear.py`` with the layer index on the device).

    Each token is encoded once: its rope'd K/V enter the cache and are never
    recomputed, which is sliding-window LLM serving (dense attention under
    a banded mask), not the reference's re-encoding.  Needs rotary
    positions; learned positions are re-based per window and would make the
    cache wrong.

    ``new_positions``: (Ln,) int absolute positions, shared across the
    batch and consecutive over ``x_new`` (a frame's tokens by contract; the
    prefill of ``rollout/streaming.py`` is ``0..Ln-1``).  Decode (default):
    ``x_new`` is one frame, written as a whole slab at ring slot
    ``write_slot``.  ``prefill=True``: the sinks followed by zero or more
    whole frames of ``frame_tokens`` tokens, written to the sink slot and
    ring slots ``0..``; ``write_slot`` is ignored.

    Unlike the functional JAX version the cache is updated IN PLACE (its
    tensors are written, not copied; ``write_slot`` is a host int) and
    returned.  Attention is ``ops/decode_attention.slab_decode`` where it
    takes the shape and ``kernels`` is set (its plain twin on CPU tensors),
    otherwise :func:`_attention_slabs`; prefill goes through the same
    kernel.  Inference only: merged adapters, no dropout.

    A MoE block routes the new tokens alone (``backbone.py:1297-1308``):
    routing reads a token's own hidden state, so it composes with the
    cache, but capacity is per decode chunk (``C`` from ``Ln``) and
    expert_choice picks among the chunk's tokens; aux is unused.
    """
    cfg = backbone.cfg
    if cfg.pos != "rope":
        raise ValueError("streaming decode requires rotary positions (llama family); "
                         f"backbone family {cfg.family!r} uses {cfg.pos!r} positions")
    bs, Ln = x_new.shape[:2]
    H, hd, kv_dim = cfg.n_heads, cfg.head_dim, cfg.kv_dim
    n_sink = cache["sink_pos"].shape[0]
    slots, pp = cache["k"].shape[2:4]
    F_ = slots - 1  # ring slots; slot F_ holds the sinks
    x = x_new.to(cfg.dtype)
    if backbone.project_in is not None:
        x = linear(x, backbone.project_in, kernels)
    pos = new_positions.to(device=x.device, dtype=torch.int32)

    if prefill:
        if frame_tokens is None:
            if Ln != n_sink:
                raise ValueError("prefill with frames needs frame_tokens= (the padded "
                                 "cache slabs don't pin the frame size)")
            frame_tokens = pp  # sinks only; any value works
        P = frame_tokens
        n_fr = (Ln - n_sink) // P
        if n_sink + n_fr * P != Ln:
            raise ValueError(f"prefill must be sinks ({n_sink}) + whole frames of {P} "
                             f"tokens; got {Ln} tokens")
        cache["sink_pos"].copy_(pos[:n_sink])
        if n_fr:
            cache["ring_pos"][:n_fr] = pos[n_sink::P]
    else:
        P = Ln  # decode appends exactly one frame
        if frame_tokens is not None and frame_tokens != P:
            raise ValueError(f"decode appends exactly one frame of {frame_tokens} tokens; got {P}")
        if P > pp:
            raise ValueError(f"frame of {P} tokens exceeds the {pp}-token slab")
        n_fr = 0
        cache["ring_pos"][write_slot] = pos[0]

    kp_row = slab_key_positions(cache, P)
    use_kernel = kernels and da.supported(cfg)
    if use_kernel:
        key_pos, q0 = da.pad_key_pos(kp_row), pos[:1]
    else:
        allowed = (kp_row[None, :] <= pos[:, None])[None, None]  # (1, 1, Ln, slots*P̂)
    rope = rope_tables(pos[None], cfg)
    ck, cv = cache["k"], cache["v"]

    if isinstance(backbone.layers, StackedLayers):
        # the stacked scan (``backbone.py:1324-1393``): every linear through
        # the indexed-linear kernel at a device layer index
        layers = backbone.layers.views[True]
    else:
        layers = backbone.layers
    for li, layer in enumerate(layers):
        lin = lambda h, group, name, layer=layer: layer.apply_linear(
            h, getattr(layer, group)[name], kernels)
        h = _norm(x, layer.ln1, cfg) if cfg.pre_ln else x
        q, k, v = layer.qkv(h, cfg, rope=rope, kernels=kernels)
        if prefill:
            ck[li, :, F_, :n_sink] = k[:, :n_sink]
            cv[li, :, F_, :n_sink] = v[:, :n_sink]
            if n_fr:
                ck[li, :, :n_fr, :P] = k[:, n_sink:].reshape(bs, n_fr, P, kv_dim)
                cv[li, :, :n_fr, :P] = v[:, n_sink:].reshape(bs, n_fr, P, kv_dim)
        else:
            # rows P..P̂ of the slab stay zero from init (always masked)
            ck[li, :, write_slot, :P] = k
            cv[li, :, write_slot, :P] = v
        if use_kernel:
            attn_flat = da.slab_decode(q, ck, cv, key_pos, q0, li, hd)
        else:
            attn_flat = _attention_slabs(q.reshape(bs, Ln, H, hd), ck[li], cv[li], allowed,
                                         cfg).reshape(bs, Ln, cfg.d_model)
        x = x + lin(attn_flat, "attn", "o")
        if not cfg.pre_ln:
            x = _norm(x, layer.ln1, cfg)
        h2 = _norm(x, layer.ln2, cfg) if cfg.pre_ln else x
        if isinstance(layer.mlp, MoEMLP):
            x = x + moe_mlp(h2, layer.mlp, cfg)[0]
        else:
            x = x + layer.mlp_out(h2, cfg, lin)
        if not cfg.pre_ln:
            x = _norm(x, layer.ln2, cfg)
    return backbone._out(x, kernels), cache
