"""Operations and bytes that FLUID-LLM's work needs, counted from its shapes.

The count convention (``PERF.md`` §3):

- a matrix product of ``(t, k) @ (k, n)`` is ``2 t k n`` operations;
- the model operations of a step are its matrix products: the forward,
  the products of the input gradients (none for the encoder's first
  linear, whose input is data), and those of the weight gradients of the
  weights that train; no recomputation;
- attention counts the (query, key) pairs it needs: a valid query and a
  valid key at or before it, so causal attention is about halved.  Its
  forward is ``4 d`` operations a pair (``q k`` and ``p v``), its backward
  twice that;
- elementwise work, norms and softmax count no model operations;
- a kernel's bytes read each input once and write each output once, of the
  rows its work needs.

``Dims`` holds the sizes a configuration file states; nothing here imports
the port.
"""

from __future__ import annotations

from dataclasses import dataclass

BF16 = 2
F32 = 4
I32 = 4


@dataclass(frozen=True)
class Dims:
    d_embed: int  # word_embed_proj_dim: the encoder's and decoder's width
    d_model: int
    d_ff: int
    n_layers: int
    n_heads: int
    lora_r: int
    lora_targets: int  # adapted projections a layer, each (d_model, d_model)
    patch_in: int  # px * py * 3
    enc_hidden: int
    enc_layers: int
    dec_hidden: int
    gnn_dim: int
    gnn_hid: int
    gnn_layers: int
    patch_pixels: int  # px * py
    n_patch: int  # patches a frame
    frame_pixels: int  # X * Y of the padded grid

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def projected(self) -> bool:
        return self.d_embed != self.d_model


def dims_of(conf: dict, geometry: dict) -> Dims:
    """``conf``: a configuration file; ``geometry``: the patch grid
    (``n_patch``, ``frame_pixels``, ``patch_pixels``)."""
    bb, fl = conf["backbone"], conf["fluid_llm"]
    enc, dec, lora = fl["encoder_params"], fl["decoder_params"], fl["lora_config"]
    return Dims(
        d_embed=bb["word_embed_proj_dim"], d_model=bb["hidden_size"], d_ff=bb["ffn_dim"],
        n_layers=bb["num_hidden_layers"], n_heads=bb["num_attention_heads"],
        lora_r=lora["r"], lora_targets=len(lora["target_modules"]),
        patch_in=geometry["patch_pixels"] * 3, enc_hidden=enc["hidden_dim"],
        enc_layers=enc["num_layers"], dec_hidden=dec["mlp_hid_dim"], gnn_dim=dec["gnn_dim"],
        gnn_hid=dec["gnn_hid_dim"], gnn_layers=dec["gnn_layers"],
        patch_pixels=geometry["patch_pixels"], n_patch=geometry["n_patch"],
        frame_pixels=geometry["frame_pixels"])


def mm(t: float, k: int, n: int) -> float:
    return 2.0 * t * k * n


def causal_pairs(n_valid: int) -> int:
    """Pairs of a row whose ``n_valid`` valid tokens attend causally."""
    return n_valid * (n_valid + 1) // 2


def tail_pairs(n_valid: int, n_query: int) -> int:
    """Pairs of the last ``n_query`` of ``n_valid`` causal tokens."""
    return n_query * n_valid - n_query * (n_query - 1) // 2


def encoder_ops(d: Dims, tokens: float) -> tuple[float, float]:
    """(all, first linear) of the patch encoder's forward over ``tokens``."""
    widths = [d.patch_in] + [d.enc_hidden] * (d.enc_layers - 1) + [d.d_embed]
    ops = [mm(tokens, a, b) for a, b in zip(widths[:-1], widths[1:])]
    return sum(ops), ops[0]


def layer_linear_ops(d: Dims, tokens: float) -> float:
    """q, k, v, o and the two MLP linears of one block."""
    return mm(tokens, d.d_model, 4 * d.d_model) + mm(tokens, d.d_model, 2 * d.d_ff)


def lora_ops(d: Dims, tokens: float) -> float:
    """The adapter branches ``(x A) B`` of one block."""
    return d.lora_targets * (mm(tokens, d.d_model, d.lora_r) + mm(tokens, d.lora_r, d.d_model))


def dora_norm_ops(d: Dims) -> float:
    """DoRA's column norm of ``W + s A B`` in closed form, once a forward a
    block: ``W A``, ``A^T A`` and the quadratic term."""
    n, r = d.d_model, d.lora_r
    return d.lora_targets * (mm(n, n, r) + mm(r, n, r) + mm(r, r, n))


def decoder_ops(d: Dims, frames: float) -> float:
    """The MLPGNN decoder's linears over ``frames``: the token MLP, then
    ``lin_l`` and ``lin_r`` of every GATv2 conv on every pixel."""
    tokens = frames * d.n_patch
    ops = mm(tokens, d.d_embed, d.dec_hidden) + mm(tokens, d.dec_hidden, d.patch_pixels * d.gnn_dim)
    widths = [d.gnn_dim] + [d.gnn_hid] * (d.gnn_layers - 1) + [3]
    for a, b in zip(widths[:-1], widths[1:]):
        ops += 2 * mm(frames * d.frame_pixels, a, b)
    return ops


def train_step_ops(d: Dims, batch: int, frames: int) -> float:
    """Model operations of one autoreg training step: ``frames`` input frames
    a row (the see-init duplicate included) and a BOS token; adapters
    unmerged, the backbone frozen, every other weight trained."""
    tokens = batch * (frames * d.n_patch + 1)
    enc, enc_first = encoder_ops(d, batch * frames * d.n_patch)
    backbone = d.n_layers * layer_linear_ops(d, tokens)
    adapters = d.n_layers * lora_ops(d, tokens)
    proj = 2 * mm(tokens, d.d_embed, d.d_model) if d.projected else 0.0
    dec = decoder_ops(d, batch * frames)
    attn = d.n_layers * 4 * d.d_model * batch * causal_pairs(frames * d.n_patch + 1)
    forward = enc + backbone + adapters + proj + dec + attn + d.n_layers * dora_norm_ops(d)
    input_grads = (enc - enc_first) + backbone + adapters + proj + dec + 2 * attn
    weight_grads = enc + adapters + dec
    return forward + input_grads + weight_grads


def window_tokens(d: Dims, step: int, window: int) -> tuple[int, int]:
    """(valid frames, valid tokens) of the rollout's window at ``step``
    (0-based) from one context frame: the last ``min(step + 1, window)``
    frames, the see-init duplicate and the BOS token."""
    frames = min(step + 1, window)
    return frames, 1 + (frames + 1) * d.n_patch


def rollout_step_ops(d: Dims, batch: int, step: int, window: int) -> float:
    """Model operations of one rollout step: the window's valid tokens through
    every block but the last; the last computes k and v over them and the
    rest over the newest frame's tokens only; that frame is decoded.
    Adapters merged."""
    frames, n = window_tokens(d, step, window)
    q = d.n_patch
    enc, _ = encoder_ops(d, batch * (frames + 1) * d.n_patch)
    full = (d.n_layers - 1) * (layer_linear_ops(d, batch * n)
                               + 4 * d.d_model * batch * causal_pairs(n))
    last = (mm(batch * n, d.d_model, 2 * d.d_model) + mm(batch * q, d.d_model, 2 * d.d_model)
            + mm(batch * q, d.d_model, 2 * d.d_ff) + 4 * d.d_model * batch * tail_pairs(n, q))
    proj = (mm(batch * n, d.d_embed, d.d_model) + mm(batch * q, d.d_model, d.d_embed)) \
        if d.projected else 0.0
    return enc + full + last + proj + decoder_ops(d, batch)


def rollout_ops(d: Dims, batch: int, steps: int, window: int) -> float:
    return sum(rollout_step_ops(d, batch, i, window) for i in range(steps))


# -- kernel work: (bytes, operations, kind) of one call ----------------------

def attention_fwd_work(d: Dims, batch: int, n_valid: int, lse: bool) -> tuple[float, float, str]:
    """The causal attention of one block over ``n_valid`` valid tokens a row:
    q, k, v read and the output written (bf16), the validity flags, and with
    ``lse`` the log-sum-exp rows the backward reads (f32)."""
    rows = batch * n_valid
    nbytes = 4 * rows * d.d_model * BF16 + rows * I32
    if lse:
        nbytes += rows * d.n_heads * F32
    return nbytes, 4.0 * d.d_model * batch * causal_pairs(n_valid), "bf16"


def attention_bwd_work(d: Dims, batch: int, n_valid: int) -> tuple[float, float, str]:
    """Its backward: q, k, v and the output's gradient read with lse and the
    row deltas, dq, dk and dv written; the scores recomputed once, then
    ``dP``, ``dV``, ``dQ`` and ``dK``: 10 d operations a pair."""
    rows = batch * n_valid
    nbytes = 7 * rows * d.d_model * BF16 + 2 * rows * d.n_heads * F32 + rows * I32
    return nbytes, 10.0 * d.d_model * batch * causal_pairs(n_valid), "bf16"


def slot_fwd_work(frames: int, pixels: int, channels: int, elem: int) -> tuple[float, float, str]:
    """The five-slot grid attention of one conv: xl and xr read, the output
    written, ``att`` (f32); 35 operations a (pixel, channel): five slots of
    add, leaky ReLU, logit and weighted sum, in f32."""
    n = frames * pixels * channels
    return 3 * n * elem + channels * F32, 35.0 * n, "f32"


def slot_bwd_work(frames: int, pixels: int, channels: int, elem: int) -> tuple[float, float, str]:
    """Its backward: xl, xr and the output's gradient read, dxl and dxr
    written, ``att`` read and its gradient written; twice the forward's
    operations."""
    n = frames * pixels * channels
    return 5 * n * elem + 2 * channels * F32, 70.0 * n, "f32"


def slot_channels(d: Dims) -> list[int]:
    """The slot attention's channels of each conv of the decoder."""
    return [d.gnn_hid] * (d.gnn_layers - 1) + [3]
