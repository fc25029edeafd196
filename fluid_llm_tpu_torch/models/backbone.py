"""Decoder-only transformer backbone (OPT / GPT-2 layouts).

Counterpart of ``fluid_llm_tpu/models/backbone.py``.  The reference feeds
pre-computed patch embeddings via ``inputs_embeds`` (token embeddings nulled,
``src/models/model.py:102-104``), so the backbone takes embeddings and has
no token table.

Fidelity notes, as in the JAX package:
- OPT/GPT-2 add their own learned 1-D position embedding on top of
  ``inputs_embeds``, with OPT's offset-2 indexing.
- Positions are ``cumsum(valid) - 1`` (clipped at 0), which equals
  ``arange(L)`` for dense inputs and stays right for the rollout's
  right-aligned window, whose invalid frames sit at the front.
- Pre-LN (default) or post-LN (OPT-350m), with ``project_in``/``project_out``
  where the embedding width differs (OPT-350m).

Attention, with ``kernels`` set and where the kernels take the shape:
without gradients (rollout, inference) it runs the exact-window kernel
(``ops/exact_attention.py``); with gradients and ``flash_attention``
(training) it runs ``ops/flash_attention.FlashAttention``, whose backward
is the dq and dk/dv kernels.  Otherwise the plain twin, under autograd.
``decode_slice`` computes the final block for one token range only
(``_final_block_sliced``, plain PyTorch).

Training (``backbone.py:769-948``): LoRA/DoRA adapters are applied unmerged
(``models/lora.lora_linear``) on their target projections, and dropout
draws from a ``torch.Generator`` at the HF placement: the embedding stream,
after the attention out-projection and after the MLP.  ``pack_qkv_params``
and ``cast_matmul_params`` are inference-only.  LLaMA/rope, MoE, streaming,
the stacked-layer layout, ring attention and tensor parallelism come later.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fluid_llm_tpu_torch.models.common import dropout, linear
from fluid_llm_tpu_torch.models.lora import lora_linear
from fluid_llm_tpu_torch.ops import exact_attention as xa
from fluid_llm_tpu_torch.ops import flash_attention as fa


@dataclass(frozen=True)
class BackboneConfig:
    family: str  # "opt" | "gpt2"
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    max_pos: int = 2048
    # OPT-350m: embeddings at ``word_embed_proj_dim`` with project_in/out,
    # post-LN blocks and no final norm (HF ``OPTConfig``)
    d_embed: Optional[int] = None
    pre_ln: bool = True
    final_ln: bool = True
    act: str = "relu"  # "relu" | "gelu_new" | "gelu"
    pos_offset: int = 0  # OPT uses 2
    ln_eps: float = 1e-5
    dropout: float = 0.1  # training only
    dtype: torch.dtype = torch.float32  # activation dtype
    # training attention through the flash kernels (``cfg.flash_attention``)
    flash_attention: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

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


def _norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm computed in f32, returned in the activation dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(x.dtype)


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


def _attention(q, k, v, allowed, dtype) -> torch.Tensor:
    """Masked attention, f32 scores and softmax, probabilities in ``dtype``.

    q: (bs, Lq, H, hd); k/v: (bs, Lk, H, hd); allowed: broadcastable to
    (bs, H, Lq, Lk).  Port of ``backbone._attention_xla``.
    """
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    logits = torch.where(allowed, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class Block(nn.Module):
    """One transformer block; ``attn``/``mlp`` are ModuleDicts so the keys
    follow the JAX pytree (``attn.q``..., ``attn.qkv`` once packed)."""

    def __init__(self, cfg: BackboneConfig):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.ln1 = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.attn = nn.ModuleDict({n: nn.Linear(d, d) for n in ("q", "k", "v", "o")})
        self.ln2 = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.mlp = nn.ModuleDict({"fc1": nn.Linear(d, ff), "fc2": nn.Linear(ff, d)})

    def proj(self, h, group: str, name: str, adapters=None, lora_cfg=None, generator=None):
        """``group.name`` applied to ``h``, through its adapter if it has one
        (unmerged; adapter dropout when ``generator`` is given)."""
        lin = getattr(self, group)[name]
        ad = adapters[group][name] if adapters is not None and group in adapters \
            and name in adapters[group] else None
        if ad is None:
            return linear(h, lin)
        return lora_linear(h, lin, ad, lora_cfg, generator)

    def qkv(self, h: torch.Tensor, d: int, adapters=None, lora_cfg=None, generator=None):
        """q, k, v of ``h``: column slices of the fused projection when packed."""
        if "qkv" in self.attn:
            if adapters is not None and "attn" in adapters \
                    and any(n in adapters["attn"] for n in "qkv"):
                raise ValueError("packed qkv weights cannot apply q/k/v adapters: merge them "
                                 "first (FluidLLM.prepare_inference_params)")
            qkv = linear(h, self.attn["qkv"])
            return qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        return tuple(self.proj(h, "attn", n, adapters, lora_cfg, generator)
                     for n in ("q", "k", "v"))

    def forward(self, x, cfg: BackboneConfig, valid_i32, attend, adapters=None, lora_cfg=None,
                generator=None) -> torch.Tensor:
        """``generator``: training (adapter and residual dropout draw from
        it); None runs without dropout."""
        lin = lambda h, group, name: self.proj(h, group, name, adapters, lora_cfg, generator)
        drop = (lambda h: dropout(h, cfg.dropout, generator)) if generator is not None \
            else (lambda h: h)
        h = _norm(x, self.ln1) if cfg.pre_ln else x
        q, k, v = self.qkv(h, cfg.d_model, adapters, lora_cfg, generator)
        x = x + drop(lin(attend(q, k, v, valid_i32, cfg.n_heads, cfg.head_dim), "attn", "o"))
        if not cfg.pre_ln:
            x = _norm(x, self.ln1)
        h = _norm(x, self.ln2) if cfg.pre_ln else x
        x = x + drop(lin(_act(lin(h, "mlp", "fc1"), cfg.act), "mlp", "fc2"))
        if not cfg.pre_ln:
            x = _norm(x, self.ln2)
        return x


class Backbone(nn.Module):
    def __init__(self, cfg: BackboneConfig):
        super().__init__()
        if cfg.family not in ("opt", "gpt2"):
            raise ValueError(f"backbone family {cfg.family!r}: only opt/gpt2 are ported")
        self.cfg = cfg
        d = cfg.d_model
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.final_norm = nn.LayerNorm(d, eps=cfg.ln_eps) if cfg.final_ln else None
        if cfg.d_embed is not None and cfg.d_embed != d:
            self.project_in = nn.Linear(cfg.d_embed, d, bias=False)
            self.project_out = nn.Linear(d, cfg.d_embed, bias=False)
        else:
            self.project_in = self.project_out = None
        self.pos_embed = nn.Parameter(torch.empty(cfg.max_pos + cfg.pos_offset, d))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX init: N(0, 0.02) weights and positions, zero biases, unit norms."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, 0.02, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.reset_parameters()
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
        """
        cfg = self.cfg
        bs, L = inputs_embeds.shape[:2]
        x = inputs_embeds.to(cfg.dtype)
        if valid is None:
            valid = torch.ones(bs, L, dtype=torch.bool, device=x.device)
        positions, allowed = make_masks(valid)
        if self.project_in is not None:
            x = linear(x, self.project_in)
        x = x + self.pos_embed[positions + cfg.pos_offset].to(cfg.dtype)
        if generator is not None:
            x = dropout(x, cfg.dropout, generator)

        if torch.is_grad_enabled():
            # the exact-window kernel has no backward; training attention is
            # the flash Function (its twins on CPU tensors) or the plain twin
            use_flash = kernels and cfg.flash_attention and fa.supported(cfg.head_dim, cfg.dtype)
            attend = fa.flash_attention if use_flash else xa.causal_attention_ref
        else:
            use_kernel = kernels and xa.supported(cfg.head_dim, cfg.dtype)
            attend = xa.causal_attention if use_kernel else xa.causal_attention_ref
        valid_i32 = valid.to(torch.int32).contiguous()
        adapters = lora.layers if lora is not None else [None] * cfg.n_layers
        lora_cfg = lora.cfg if lora is not None else None
        n_full = cfg.n_layers - (1 if decode_slice is not None else 0)
        for layer, ad in zip(self.layers[:n_full], adapters):
            x = layer(x, cfg, valid_i32, attend, ad, lora_cfg, generator)
        if decode_slice is not None:
            x = self._final_block_sliced(x, allowed, decode_slice, adapters[-1], lora_cfg)

        if self.final_norm is not None:
            x = _norm(x, self.final_norm)
        if self.project_out is not None:
            x = linear(x, self.project_out)
        return x

    def _final_block_sliced(self, x, allowed, decode_slice, adapters=None,
                            lora_cfg=None) -> torch.Tensor:
        """Final block for queries ``start:start+length`` only (exact under
        causal attention; ``backbone.py:951-1029``), adapters unmerged if
        given.  Plain PyTorch, no dropout."""
        cfg = self.cfg
        layer = self.layers[-1]
        lin = lambda h, group, name: layer.proj(h, group, name, adapters, lora_cfg)
        start, ln = decode_slice
        bs, L, d = x.shape
        H, hd = cfg.n_heads, cfg.head_dim

        h = _norm(x, layer.ln1) if cfg.pre_ln else x
        x_s = x[:, start:start + ln]
        h_q = h[:, start:start + ln]
        if "qkv" in layer.attn:
            # packed weights: q over the slice, fused k|v over the full window
            p = layer.attn["qkv"]
            w = p.weight.to(h.dtype)
            b = p.bias.to(h.dtype)
            q = F.linear(h_q, w[:d], b[:d])
            kv = F.linear(h, w[d:], b[d:])
            k, v = kv[..., :d], kv[..., d:]
        else:
            q = lin(h_q, "attn", "q")
            k = lin(h, "attn", "k")
            v = lin(h, "attn", "v")
        q = q.reshape(bs, ln, H, hd)
        k = k.reshape(bs, L, H, hd)
        v = v.reshape(bs, L, H, hd)

        attn_out = _attention(q, k, v, allowed[:, :, start:start + ln], cfg.dtype)
        x_s = x_s + lin(attn_out.reshape(bs, ln, d), "attn", "o")
        if not cfg.pre_ln:
            x_s = _norm(x_s, layer.ln1)

        h2 = _norm(x_s, layer.ln2) if cfg.pre_ln else x_s
        x_s = x_s + lin(_act(lin(h2, "mlp", "fc1"), cfg.act), "mlp", "fc2")
        if not cfg.pre_ln:
            x_s = _norm(x_s, layer.ln2)
        return x_s


@torch.no_grad()
def pack_qkv_params(backbone: Backbone) -> None:
    """Fuse each layer's q/k/v projections into one ``qkv`` linear, in place.

    Exact (same math, one matmul instead of three).  Apply AFTER
    ``merge_lora``: adapters target the unpacked names.
    """
    for layer in backbone.layers:
        attn = layer.attn
        if "qkv" in attn:
            continue
        parts = [attn[n] for n in ("q", "k", "v")]
        qkv = nn.Linear(parts[0].in_features, sum(p.out_features for p in parts),
                        device=parts[0].weight.device, dtype=parts[0].weight.dtype)
        qkv.weight.copy_(torch.cat([p.weight for p in parts], dim=0))
        qkv.bias.copy_(torch.cat([p.bias for p in parts]))
        for n in ("q", "k", "v"):
            del attn[n]
        attn["qkv"] = qkv


@torch.no_grad()
def cast_matmul_params(backbone: Backbone, dtype: torch.dtype) -> None:
    """Store the layers' matmul weights in the activation dtype, in place.

    Exact for inference: every matmul casts its weight to the activation
    dtype anyway.  Norms and the position table stay f32 (computed in f32 /
    cast at use, as in the JAX package).
    """
    for layer in backbone.layers:
        for group in (layer.attn, layer.mlp):
            for lin in group.values():
                lin.to(dtype)
    for lin in (backbone.project_in, backbone.project_out):
        if lin is not None:
            lin.to(dtype)
