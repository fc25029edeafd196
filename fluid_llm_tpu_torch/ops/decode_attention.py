"""Decode attention over the streaming slab KV cache, read in place.

Counterpart of ``fluid_llm_tpu/ops/decode_attention.py``.  The kernel is
``csrc/decode_attention.cu`` (CUDA C++ for ``sm_90a``); it replaces the TPU
kernel ``fluid_llm_tpu/ops/decode_attention.py:_kernel`` (``slab_decode``).

What it computes: ``P`` new rope'd queries ``(bs, P, H*hd)`` against layer
``li`` of the stacked cache ``(L, bs, slots, P̂, H*hd)`` (``backbone.
init_streaming_cache``), keys in slab order, with one int32 key-position
row: ``allowed[i, j] = key_pos[j] <= q0 + i`` (INT32_MAX marks slab pad
rows and unwritten slots).  Scores and softmax in f32, probabilities
rounded to bf16 for the PV product, f32 sums.  Forward only.

Bound and design, in short (the source's header has the detail): one
layer's K/V at the flagship shape (11 slots x 64 rows x 768, bs 1) is
~2.2 MB and the step is ~12 x 60 x 704 x 64 x 4 ~= 130 MFLOP, so the
kernel is latency bound.  It runs one block per (64-query tile, head,
batch), reads layer ``li`` through strides from the stacked buffer (no
per-layer slice, no copy), walks the 64-key tiles with an online softmax
and skips a tile whose keys no query of the block may see (unwritten ring
slots, and every ring slot in the prefill).  At bs 1 that is 12 blocks on
132 SMs; splitting the keys across blocks is the next step.
"""

from __future__ import annotations

import ctypes

import torch

from fluid_llm_tpu_torch.ops import _build
from fluid_llm_tpu_torch.ops.exact_attention import HEAD_DIMS, row_stride

INT32_MAX = torch.iinfo(torch.int32).max
KEY_TILE = 64  # the kernel's key tile: the key-position row is padded to it


def pad_key_pos(kp_row: torch.Tensor) -> torch.Tensor:
    """(slots*P̂,) int32 -> (1, kpad) padded with INT32_MAX to a multiple of
    the kernel's 64-key tile (the TPU kernel padded to its 128 lanes)."""
    pad = (-kp_row.shape[0]) % KEY_TILE
    if pad:
        kp_row = torch.cat([kp_row, kp_row.new_full((pad,), INT32_MAX)])
    return kp_row[None]


def supported(cfg) -> bool:
    """Shape gate (``decode_attention.py:148-155``): full-head attention (no
    grouped-query repeat in the kernel), heads of 32, 64 or 128, bf16.  The
    TPU gate's 128-lane head groups were its tiling and do not apply."""
    return cfg.kv_heads == cfg.n_heads and cfg.head_dim in HEAD_DIMS \
        and cfg.dtype == torch.bfloat16


def slab_decode_ref(q, k_cache, v_cache, key_pos, q0, li: int, head_dim: int) -> torch.Tensor:
    """Plain PyTorch twin: the math of ``_kernel`` and of
    ``backbone._attention_slabs`` (f32 scores and softmax, probabilities in
    the value dtype before PV).

    q: (bs, P, H*hd); k/v_cache: (L, bs, slots, P̂, H*hd); key_pos: (1, kpad)
    int32 with kpad >= slots*P̂; q0: int32 tensor whose first element is the
    first query's position.  Returns (bs, P, H*hd).
    """
    bs, P, D = q.shape
    H = D // head_dim
    slots, pp = k_cache.shape[2:4]
    tot = slots * pp
    k = k_cache[li].reshape(bs, tot, H, head_dim)
    v = v_cache[li].reshape(bs, tot, H, head_dim)
    qpos = q0.reshape(-1)[:1] + torch.arange(P, device=q.device)
    allowed = key_pos[0, :tot][None, :] <= qpos[:, None]  # (P, tot)
    lg = torch.einsum("bqhd,bkhd->bhqk", q.reshape(bs, P, H, head_dim).float(), k.float())
    lg = torch.where(allowed, lg * head_dim ** -0.5, torch.finfo(torch.float32).min)
    p = torch.softmax(lg, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(bs, P, D)


def slab_decode(q, k_cache, v_cache, key_pos, q0, li: int, head_dim: int) -> torch.Tensor:
    """One layer's attention of new queries over the slab cache.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`slab_decode_ref`.  ``q`` may be a column slice of a fused
    projection (any row stride); the caches must be contiguous and are read
    at layer ``li`` in place.  Forward only: on CUDA it raises when autograd
    would need a backward.
    """
    if q.device.type == "cpu":
        return slab_decode_ref(q, k_cache, v_cache, key_pos, q0, li, head_dim)
    if q.device.type != "cuda":
        raise ValueError(f"slab_decode: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k_cache, v_cache)):
        raise RuntimeError("slab_decode: the decode-attention kernel is forward only")
    bs, P, D = q.shape
    if head_dim not in HEAD_DIMS or D % head_dim:
        raise ValueError(f"slab_decode: D {D}, head_dim {head_dim}")
    n_layers, cbs, slots, pp, Dk = k_cache.shape
    if cbs != bs or Dk != D or v_cache.shape != k_cache.shape or not 0 <= li < n_layers:
        raise ValueError(f"slab_decode: q {tuple(q.shape)}, cache {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)}, layer {li} (full heads only)")
    if not (q.dtype == k_cache.dtype == v_cache.dtype == torch.bfloat16):
        raise ValueError(f"slab_decode: bf16 only, got {q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("slab_decode: the caches must be contiguous")
    n_keys = slots * pp
    for t, name in ((k_cache, "k_cache"), (v_cache, "v_cache"), (key_pos, "key_pos"),
                    (q0, "q0")):
        if t.device != q.device:
            raise ValueError(f"slab_decode: {name} on {t.device}, q on {q.device}")
    if key_pos.dtype != torch.int32 or key_pos.dim() != 2 or key_pos.shape[0] != 1 \
            or key_pos.shape[1] < n_keys or not key_pos.is_contiguous():
        raise ValueError(f"slab_decode: key_pos must be contiguous int32 (1, >= {n_keys})")
    if q0.dtype != torch.int32 or q0.numel() < 1:
        raise ValueError("slab_decode: q0 must be an int32 tensor")
    q_rs = row_stride(q, "q", bs, P, D)
    out = torch.empty((bs, P, D), dtype=q.dtype, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.slab_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), key_pos.data_ptr(),
            q0.data_ptr(), out.data_ptr(), bs, P, D // head_dim, head_dim, n_keys, li,
            q_rs, D, ctypes.c_float(head_dim ** -0.5), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "slab_decode_attention")
    slab_decode.launches += 1
    return out


slab_decode.launches = 0  # kernel launches in this process
