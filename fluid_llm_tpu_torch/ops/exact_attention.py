"""Causal attention for the exact-rollout window (~661 tokens), packed layout.

Counterpart of ``fluid_llm_tpu/ops/exact_attention.py``.  The kernel is
``csrc/exact_attention.cu`` (CUDA C++ for ``sm_90a``); it replaces the TPU
kernel ``fluid_llm_tpu/ops/exact_attention.py:_kernel``.

Bound and design, in short (the source's header has the detail): at the
rollout geometry one layer is ~0.67 GFLOP over ~3 MB, too little to fill the
card, so the kernel is latency bound.  It runs one block per (64-query tile,
head, batch) -- 132 blocks at L 661, H 12 -- walks the 64-key tiles only up
to the diagonal with an online softmax in f32, and reads q/k/v in place in
the packed ``(bs, L, H*hd)`` layout through row strides, so the column
slices of a fused qkv projection need no copy and no transpose.

Forward only: the rollout and inference run it without gradients; the
training forward goes through ``ops/flash_attention.py``, whose forward is
this kernel's tile loop writing the row logsumexp as well.

The mask reproduces ``backbone.make_masks`` exactly:
``allowed[i, j] = (j <= i and valid[j]) or j == i`` (the forced diagonal
keeps rows of invalid queries finite; their outputs are unused).
"""

from __future__ import annotations

import ctypes

import torch

from fluid_llm_tpu_torch.ops import _build

HEAD_DIMS = (32, 64, 128)


def causal_attention_ref(q, k, v, valid, n_heads: int, head_dim: int) -> torch.Tensor:
    """Plain PyTorch twin: a port of ``_xla_packed``
    (``fluid_llm_tpu/ops/exact_attention.py:127-143``).

    q/k/v: (bs, L, n_heads*head_dim); valid: (bs, L) int or bool.  Scores and
    softmax in f32, probabilities cast to the value dtype before PV.
    """
    bs, L, D = q.shape
    qh = q.reshape(bs, L, n_heads, head_dim)
    kh = k.reshape(bs, L, n_heads, head_dim)
    vh = v.reshape(bs, L, n_heads, head_dim)
    causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    allowed = causal[None] & (valid != 0)[:, None, :]
    allowed = (allowed | torch.eye(L, dtype=torch.bool, device=q.device)[None])[:, None]
    lg = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
    lg = torch.where(allowed, lg * head_dim ** -0.5, torch.finfo(torch.float32).min)
    p = torch.softmax(lg, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vh)
    return out.reshape(bs, L, D)


def supported(head_dim: int, dtype: torch.dtype) -> bool:
    """Shapes the kernel takes: heads of 32, 64 or 128, bf16.

    The TPU predicate (``exact_attention.py:179-188``) also asked for
    ``L >= 256`` (launch amortisation, measured on the TPU) and 128-lane head
    groups (its tiling); neither applies to this kernel.  Its full-heads
    clause holds for every backbone ported so far (no grouped-query
    attention yet).
    """
    return head_dim in HEAD_DIMS and dtype == torch.bfloat16


def row_stride(t: torch.Tensor, name: str, bs: int, L: int, D: int) -> int:
    """Row stride of a (bs, L, D) tensor the kernel can read in place."""
    if t.shape != (bs, L, D):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {(bs, L, D)}")
    rs = t.stride(1)
    if t.stride(2) != 1 or t.stride(0) != L * rs or rs % 8 or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: needs unit channel stride, rows of a multiple of 8 elements, "
            f"batches of L rows and a 16-byte aligned start (strides {t.stride()})"
        )
    return rs


def causal_attention(q, k, v, valid, n_heads: int, head_dim: int) -> torch.Tensor:
    """Packed causal attention: (bs, L, D) x3 + (bs, L) validity -> (bs, L, D).

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`causal_attention_ref`.  ``q``/``k``/``v`` may be column slices of
    one fused projection output (any row stride); ``valid`` is int32.

    The kernel has no backward: on CUDA it raises when autograd would need
    one (grad enabled and an input that requires grad) rather than return an
    output the gradient silently stops at.  Training attention goes through
    ``ops/flash_attention.FlashAttention``.
    """
    if q.device.type == "cpu":
        return causal_attention_ref(q, k, v, valid, n_heads, head_dim)
    if q.device.type != "cuda":
        raise ValueError(f"causal_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("causal_attention: the exact-window kernel is forward only; "
                           "under autograd use ops.flash_attention.flash_attention")
    bs, L, D = q.shape
    if D != n_heads * head_dim or head_dim not in HEAD_DIMS:
        raise ValueError(f"causal_attention: D {D}, heads {n_heads} x {head_dim}")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"causal_attention: bf16 only, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (k.device == v.device == valid.device == q.device):
        raise ValueError("causal_attention: all inputs must be on one device")
    if valid.dtype != torch.int32 or valid.shape != (bs, L) or not valid.is_contiguous():
        raise ValueError("causal_attention: valid must be contiguous int32 (bs, L)")
    strides = [row_stride(t, n, bs, L, D) for t, n in ((q, "q"), (k, "k"), (v, "v"))]
    out = torch.empty((bs, L, D), dtype=q.dtype, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.exact_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(),
            bs, L, n_heads, head_dim, *strides, D, ctypes.c_float(head_dim ** -0.5),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "exact_attention_fwd")
    causal_attention.launches += 1
    return out


causal_attention.launches = 0  # kernel launches in this process
