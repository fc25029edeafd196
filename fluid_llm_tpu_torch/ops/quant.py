"""Weight-only quantization of the backbone's linears (serving storage).

Counterpart of ``fluid_llm_tpu/ops/quant.py``.  Two storage modes:

- ``int8``: per-output-channel symmetric absmax, 1 byte a weight.
  :class:`QuantLinear` keeps ``q`` int8 ``(out, in)`` (the ``nn.Linear``
  orientation; the JAX leaf is its transpose), ``scale`` f32 ``(out,)``,
  the optional bias in f32 and its matmul mode (``w8a16``, the default:
  bf16 activations, the JAX package's default dequantised path; or
  ``w8a8``, opt-in: activations quantised to int8 a row;
  ``ops/quant_matmul.py``).
- ``nf4``: QLoRA 4-bit NormalFloat, two codes a byte, absmax per 64
  weights, the absmax vector double-quantized to int8 per 256-chunk with a
  global mean offset.  :class:`NF4Linear` keeps the JAX leaves as they are
  (``codes`` ``(in, out/2)`` uint8, ``absmax_q``, ``absmax_scale``,
  ``absmax_offset``); it is dequantized on use, as ``materialize_w`` does.

The int8 arithmetic runs in the weight's dtype in the JAX order, so ``q``
and ``scale`` equal the JAX package's bit for bit (``torch.round`` rounds
half to even like ``jnp.round``).  The divisor 127 is a tensor on the
weight's device: PyTorch's CUDA division by a Python scalar multiplies by
its reciprocal, which would round differently.  The nf4 packer is a copy of
the numpy original (argmin tie order, double-quantized absmax).  MoE expert
banks are not ported.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

# The QLoRA NF4 codebook: quantiles of N(0,1) normalised to [-1, 1]
# (Dettmers et al. 2023; identical to bitsandbytes' nf4 data type).
NF4_CODEBOOK = np.array(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    dtype=np.float32,
)

NF4_BLOCK = 64  # weights per absmax block (bitsandbytes default)
NF4_CHUNK = 256  # absmax values per double-quantization chunk
QMM_MODES = ("w8a8", "w8a16")


def quantize_weight(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """(out, in) float -> {'q': int8 (out, in), 'scale': f32 (out,)}:
    symmetric absmax per output channel (``quant.py:44-51``)."""
    if w.dim() != 2:
        raise NotImplementedError(f"quantize_weight: weight of shape {tuple(w.shape)}; stacked "
                                  "MoE expert banks are not ported (MoE is not ported)")
    absmax = w.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax / absmax.new_full((), 127.0), 1.0)
    q = torch.round(w / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """int8 (out, in) and f32 (out,) -> the (out, in) weight in ``dtype``."""
    return (q.float() * scale[:, None]).to(dtype)


def quantize_weight_nf4(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """(out, in) float -> packed nf4 storage of ``w.T`` in the JAX layout:
    ``codes`` (in, out//2) uint8, byte (i, j) packing columns 2j (low
    nibble) and 2j+1 (high nibble); absmax blocks run over the row-major
    flattened (in, out) weight (``quant.py:58-94``, numpy)."""
    wt = w.detach().float().cpu().numpy().T
    d_in, d_out = wt.shape
    assert d_out % 2 == 0, wt.shape
    assert (d_in * d_out) % NF4_BLOCK == 0, wt.shape
    flat = np.ascontiguousarray(wt, np.float32).reshape(-1, NF4_BLOCK)
    absmax = np.abs(flat).max(axis=1)
    normed = flat / np.where(absmax > 0, absmax, 1.0)[:, None]
    idx = np.abs(normed.reshape(-1, 1) - NF4_CODEBOOK[None, :]).argmin(axis=1)
    idx = idx.astype(np.uint8).reshape(d_in, d_out)
    codes = (idx[:, 0::2] | (idx[:, 1::2] << 4)).astype(np.uint8)

    nb = absmax.shape[0]
    offset = absmax.mean(dtype=np.float64).astype(np.float32)
    centred = absmax - offset
    nbp = -(-nb // NF4_CHUNK) * NF4_CHUNK
    centred = np.pad(centred, (0, nbp - nb))
    chunks = centred.reshape(-1, NF4_CHUNK)
    cscale = np.abs(chunks).max(axis=1)
    cscale = np.where(cscale > 0, cscale / 127.0, 1.0).astype(np.float32)
    q8 = np.clip(np.round(chunks / cscale[:, None]), -127, 127).astype(np.int8)
    dev = w.device
    return {
        "codes": torch.from_numpy(codes).to(dev),
        "absmax_q": torch.from_numpy(q8.reshape(-1)).to(dev),
        "absmax_scale": torch.from_numpy(cscale).to(dev),
        "absmax_offset": torch.tensor(offset, dtype=torch.float32, device=dev),
    }


def dequantize_weight_nf4(codes, absmax_q, absmax_scale, absmax_offset,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """Packed nf4 -> the (in, out) weight in ``dtype`` (``quant.py:97-114``)."""
    d_in, half = codes.shape
    d_out = half * 2
    nb = d_in * d_out // NF4_BLOCK
    idx = torch.stack([codes & 0xF, codes >> 4], dim=-1).reshape(d_in, d_out).long()
    vals = torch.from_numpy(NF4_CODEBOOK).to(codes.device)[idx]
    absmax = (absmax_q.float().reshape(-1, NF4_CHUNK)
              * absmax_scale[:, None]).reshape(-1)[:nb] + absmax_offset
    return (vals.reshape(-1, NF4_BLOCK) * absmax[:, None]).reshape(d_in, d_out).to(dtype)


class QuantLinear(nn.Module):
    """An ``nn.Linear`` stored as int8 (buffers, not parameters: frozen).
    ``models.common.linear`` applies it through ``ops/quant_matmul``."""

    def __init__(self, in_features: int, out_features: int, bias: bool, mode: str = "w8a16",
                 device=None):
        super().__init__()
        if mode not in QMM_MODES:
            raise ValueError(f"matmul mode {mode!r}; one of {QMM_MODES}")
        self.in_features, self.out_features, self.mode = in_features, out_features, mode
        self.register_buffer("q", torch.zeros(out_features, in_features, dtype=torch.int8,
                                              device=device))
        self.register_buffer("scale", torch.ones(out_features, device=device))
        self.register_buffer("bias", torch.zeros(out_features, device=device) if bias else None)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear, mode: str = "w8a16") -> "QuantLinear":
        qp = quantize_weight(lin.weight)
        out = cls(lin.in_features, lin.out_features, lin.bias is not None, mode,
                  device=lin.weight.device)
        out.q.copy_(qp["q"])
        out.scale.copy_(qp["scale"])
        if lin.bias is not None:
            out.bias.copy_(lin.bias.float())
        return out

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return dequantize_weight(self.q, self.scale, dtype)


class NF4Linear(nn.Module):
    """An ``nn.Linear`` stored as nf4, dequantized on use."""

    def __init__(self, in_features: int, out_features: int, bias: bool, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        n_blocks = in_features * out_features // NF4_BLOCK
        n_chunks = -(-n_blocks // NF4_CHUNK)
        self.register_buffer("codes", torch.zeros(in_features, out_features // 2,
                                                  dtype=torch.uint8, device=device))
        self.register_buffer("absmax_q", torch.zeros(n_chunks * NF4_CHUNK, dtype=torch.int8,
                                                     device=device))
        self.register_buffer("absmax_scale", torch.ones(n_chunks, device=device))
        self.register_buffer("absmax_offset", torch.zeros((), device=device))
        self.register_buffer("bias", torch.zeros(out_features, device=device) if bias else None)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear) -> "NF4Linear":
        out = cls(lin.in_features, lin.out_features, lin.bias is not None,
                  device=lin.weight.device)
        for name, t in quantize_weight_nf4(lin.weight).items():
            getattr(out, name).copy_(t)
        if lin.bias is not None:
            out.bias.copy_(lin.bias.float())
        return out

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        """The (out, in) weight in ``dtype``."""
        return dequantize_weight_nf4(self.codes, self.absmax_q, self.absmax_scale,
                                     self.absmax_offset, dtype).T


def _backbone_linears(backbone: nn.Module):
    """(parent, name) of every linear ``quantize_backbone`` stores: each
    layer's attention and MLP projections, ``project_in``/``project_out``
    (``getattr``/``setattr`` reach both kinds of parent)."""
    for layer in backbone.layers:
        for group in (layer.attn, layer.mlp):
            for name in list(group.keys()):
                yield group, name
    for name in ("project_in", "project_out"):
        if getattr(backbone, name) is not None:
            yield backbone, name


@torch.no_grad()
def quantize_backbone(backbone: nn.Module, mode: str = "nf4", qmm_mode: str = "w8a16") -> None:
    """Store every linear of the backbone quantized, in place (``quant.py:121-155``):
    ``mode`` "int8" (:class:`QuantLinear` applied in ``qmm_mode``) or "nf4"
    (:class:`NF4Linear`; a shape nf4 cannot pack falls back to int8, as in
    the JAX package).  Norms, biases and position tables stay float."""
    if mode not in ("nf4", "int8"):
        raise ValueError(mode)
    for container, key in _backbone_linears(backbone):
        lin = getattr(container, key)
        if not isinstance(lin, nn.Linear):
            continue  # stored quantized already
        packable = lin.out_features % 2 == 0 \
            and (lin.in_features * lin.out_features) % NF4_BLOCK == 0
        if mode == "nf4" and packable:
            setattr(container, key, NF4Linear.from_linear(lin))
        else:
            setattr(container, key, QuantLinear.from_linear(lin, qmm_mode))


@torch.no_grad()
def dequantize_backbone(backbone: nn.Module, dtype=torch.bfloat16) -> None:
    """Inverse of :func:`quantize_backbone`, in place: every quantized linear
    becomes an ``nn.Linear`` holding its dequantized weight in ``dtype``."""
    for container, key in _backbone_linears(backbone):
        mod = getattr(container, key)
        if not isinstance(mod, (QuantLinear, NF4Linear)):
            continue
        w = mod.dequantize(dtype)
        lin = nn.Linear(mod.in_features, mod.out_features, bias=mod.bias is not None,
                        device=w.device, dtype=dtype)
        lin.weight.copy_(w)
        if mod.bias is not None:
            lin.bias.copy_(mod.bias)
        setattr(container, key, lin)


@torch.no_grad()
def quantization_error(backbone: nn.Module) -> float:
    """Max relative int8 reconstruction error over the backbone's float
    linears (diagnostics, ``quant.py:176-194``)."""
    errs = []
    for container, key in _backbone_linears(backbone):
        lin = getattr(container, key)
        if isinstance(lin, nn.Linear):
            qp = quantize_weight(lin.weight)
            rec = dequantize_weight(qp["q"], qp["scale"], torch.float32)
            denom = torch.clamp(lin.weight.abs().max(), min=1e-12)
            errs.append(float((rec - lin.weight).abs().max() / denom))
    return max(errs) if errs else 0.0
