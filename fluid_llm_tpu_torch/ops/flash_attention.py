"""Training attention: causal, key-valid attention with a backward.

Counterpart of ``fluid_llm_tpu/ops/flash_attention.py`` (the JAX package's
``custom_vjp`` at :363-380).  Three CUDA kernels replace its three TPU
kernels:

- forward with the per-row logsumexp, ``flash_attention_fwd`` in
  ``csrc/exact_attention.cu`` (replaces ``_fwd_kernel`` :55): the
  exact-window forward's kernel (TMA ring, ``wgmma``, the online softmax
  in registers), which also writes ``lse``;
- ``dq`` and ``dk/dv``, ``csrc/flash_attention.cu`` (replace ``_dq_kernel``
  :190 and ``_dkv_kernel`` :230, both launched by ``_flash_backward``
  :275), flash-2 style, from ``lse`` and ``delta = rowsum(dO * O)``;
  ``delta`` is a plain elementwise+reduce outside the kernels, where the
  JAX package has it (:277-278), handed over as f32 ``(bs, H, L)`` like
  ``lse`` (:func:`row_delta`; the JAX package transposes it the same way,
  :283), so a tile's statistics are one contiguous run.

q/k/v are packed ``(bs, L, H*hd)`` bf16, read in place through row strides
(no ``(bs*H, L, hd)`` transpose, no padding copy); ``lse`` is f32
``(bs, H, L)``.  The mask is ``_mask`` (:45-47): causal AND key-valid, the
diagonal always allowed.

The backward kernels, in short (the source's header has the detail): on
paper the bytes bound them (at the training step's (8, 601, 768) ~11 and
~13 us against ~7 and ~9 us of tensor-core work); in practice the chain of
each 64-row tile step.  A producer warp streams 64-row tiles by TMA into
a two-stage ring of shared memory on mbarriers (Q and dO for dk/dv, K and
V for dq) while one consumer warpgroup keeps its block's 64 rows resident
and runs ``wgmma``: the scores, P and dS stay in registers, each product's
accumulator becoming the next one's A operand.  The blocks of the longest
causal walks start first (:func:`query_tiles`, :func:`key_tiles`).  No
atomics: dq, dk and dv repeat bit for bit.

:class:`FlashAttention` is the ``torch.autograd.Function``.  On CPU tensors
its forward and backward are the plain twins :func:`flash_forward_ref` and
:func:`flash_backward_ref`; on CUDA tensors they launch the kernels or
raise.
"""

from __future__ import annotations

import ctypes

import torch

from fluid_llm_tpu_torch.ops import _build
from fluid_llm_tpu_torch.ops import exact_attention as xa
from fluid_llm_tpu_torch.ops.exact_attention import HEAD_DIMS, TILE, row_stride


def _allowed(valid: torch.Tensor, L: int) -> torch.Tensor:
    """(bs, 1, L, L) bool: ``flash_attention._mask`` for every batch row."""
    causal = torch.ones(L, L, dtype=torch.bool, device=valid.device).tril()
    eye = torch.eye(L, dtype=torch.bool, device=valid.device)
    return ((causal[None] & (valid != 0)[:, None, :]) | eye[None])[:, None]


def flash_forward_ref(q, k, v, valid, n_heads: int, head_dim: int):
    """Plain twin of the forward: a port of ``_reference_attention``
    (``flash_attention.py:100``) that also returns the row logsumexp.

    q/k/v: (bs, L, n_heads*head_dim); valid: (bs, L) int or bool.  Returns
    (out like q, lse f32 (bs, n_heads, L)).  Scores and softmax in f32,
    probabilities cast to the value dtype before PV.
    """
    bs, L, D = q.shape
    qh, kh, vh = (t.reshape(bs, L, n_heads, head_dim) for t in (q, k, v))
    lg = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) * head_dim ** -0.5
    lg = torch.where(_allowed(valid, L), lg, -torch.inf)
    lse = torch.logsumexp(lg, dim=-1)
    p = torch.exp(lg - lse[..., None]).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vh).reshape(bs, L, D)
    return out, lse


def flash_backward_ref(q, k, v, valid, out, lse, dout, n_heads: int, head_dim: int):
    """Plain twin of the backward: the math of ``_flash_backward``, in f32.

    ``delta = rowsum(dO * O)``; p recomputed from ``lse``;
    ``ds = p * (dO.v - delta)``; dq = scale ds k, dk = scale ds^T q,
    dv = p^T dO.  Returns (dq, dk, dv) like q.
    """
    bs, L, D = q.shape
    scale = head_dim ** -0.5
    qh, kh, vh, oh, gh = (t.float().reshape(bs, L, n_heads, head_dim)
                          for t in (q, k, v, out, dout))
    delta = (gh * oh).sum(-1).transpose(1, 2)  # (bs, H, L)
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    p = torch.where(_allowed(valid, L), torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, vh)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qh) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gh)
    return tuple(t.reshape(bs, L, D).to(q.dtype) for t in (dq, dk, dv))


def supported(head_dim: int, dtype: torch.dtype) -> bool:
    """Shapes the kernels take: heads of 32, 64 or 128, bf16."""
    return head_dim in HEAD_DIMS and dtype == torch.bfloat16


def row_delta(out: torch.Tensor, dout: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` per head, f32 ``(bs, H, L)`` contiguous:
    the backward kernels' layout (that of ``lse``)."""
    bs, L, _ = out.shape
    prod = dout.float() * out  # in f32: out is widened inside the multiply
    return prod.reshape(bs, L, n_heads, head_dim).sum(-1).transpose(1, 2).contiguous()


query_tiles = xa.query_tiles  # the dq blocks are the forward's: longest walk first


def key_tiles(L: int) -> list[range]:
    """The keys of each dk/dv block of one (batch, head), in launch order:
    the first tiles, which walk the most queries, first."""
    return [range(t * TILE, min(L, (t + 1) * TILE)) for t in range(-(-L // TILE))]


def walk(kernel: str, L: int, tile: range) -> int:
    """Tiles a block streams: the key tiles up to the block's last query
    (dq), or the query tiles from the block's first key on (dk/dv)."""
    if kernel == "dq":
        return xa.walk(tile)
    return -(-L // TILE) - tile.start // TILE


def _check(name: str, q, tensors, valid, n_heads: int, head_dim: int) -> list[int]:
    """Validate the CUDA launch's inputs; returns the row strides of
    ``tensors`` (each a (bs, L, D) bf16 tensor on q's device)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    bs, L, D = q.shape
    if D != n_heads * head_dim or head_dim not in HEAD_DIMS:
        raise ValueError(f"{name}: D {D}, heads {n_heads} x {head_dim}")
    for t, n in tensors:
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise ValueError(f"{name}: {n} must be bf16 on {q.device}, got {t.dtype} on {t.device}")
    if valid.dtype != torch.int32 or valid.shape != (bs, L) or not valid.is_contiguous() \
            or valid.device != q.device:
        raise ValueError(f"{name}: valid must be contiguous int32 (bs, L) on {q.device}")
    return [row_stride(t, n, bs, L, D) for t, n in tensors]


def _stat(t: torch.Tensor, name: str, shape: tuple, device) -> None:
    if t.dtype != torch.float32 or t.shape != shape or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name}: needs contiguous f32 {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def flash_forward(q, k, v, valid, n_heads: int, head_dim: int):
    """(out (bs, L, D), lse f32 (bs, H, L)).  CUDA tensors launch the
    kernel (or raise); CPU tensors take :func:`flash_forward_ref`."""
    if q.device.type == "cpu":
        return flash_forward_ref(q, k, v, valid, n_heads, head_dim)
    strides = _check("flash_forward", q, ((q, "q"), (k, "k"), (v, "v")), valid,
                     n_heads, head_dim)
    bs, L, D = q.shape
    out = torch.empty((bs, L, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((bs, n_heads, L), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bs, L, n_heads, head_dim, *strides, D,
            ctypes.c_float(head_dim ** -0.5), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "flash_attention_fwd")
    flash_forward.launches += 1
    return out, lse


def flash_dq(q, k, v, dout, lse, delta, valid, n_heads: int, head_dim: int) -> torch.Tensor:
    """dq (bs, L, D) bf16 from the saved forward state; CUDA only.
    ``delta``: f32 (bs, H, L), ``rowsum(dO * O)`` per head (:func:`row_delta`)."""
    strides = _check("flash_dq", q, ((q, "q"), (k, "k"), (v, "v"), (dout, "dout")), valid,
                     n_heads, head_dim)
    bs, L, D = q.shape
    _stat(lse, "lse", (bs, n_heads, L), q.device)
    _stat(delta, "delta", (bs, n_heads, L), q.device)
    dq = torch.empty((bs, L, D), dtype=q.dtype, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), valid.data_ptr(), dq.data_ptr(), bs, L, n_heads, head_dim,
            *strides, D, ctypes.c_float(head_dim ** -0.5),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "flash_attention_dq")
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, dout, lse, delta, valid, n_heads: int, head_dim: int):
    """(dk, dv) (bs, L, D) bf16 from the saved forward state; CUDA only."""
    strides = _check("flash_dkv", q, ((q, "q"), (k, "k"), (v, "v"), (dout, "dout")), valid,
                     n_heads, head_dim)
    bs, L, D = q.shape
    _stat(lse, "lse", (bs, n_heads, L), q.device)
    _stat(delta, "delta", (bs, n_heads, L), q.device)
    dk = torch.empty((bs, L, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), valid.data_ptr(), dk.data_ptr(), dv.data_ptr(), bs, L, n_heads,
            head_dim, *strides, D, D, ctypes.c_float(head_dim ** -0.5),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "flash_attention_dkv")
    flash_dkv.launches += 1
    return dk, dv


def flash_backward(q, k, v, valid, out, lse, dout, n_heads: int, head_dim: int):
    """(dq, dk, dv).  CUDA tensors launch the two kernels (or raise); CPU
    tensors take :func:`flash_backward_ref`."""
    if q.device.type == "cpu":
        return flash_backward_ref(q, k, v, valid, out, lse, dout, n_heads, head_dim)
    dout = dout.contiguous()
    delta = row_delta(out, dout, n_heads, head_dim)
    dq = flash_dq(q, k, v, dout, lse, delta, valid, n_heads, head_dim)
    dk, dv = flash_dkv(q, k, v, dout, lse, delta, valid, n_heads, head_dim)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Causal, key-valid attention whose backward is the dq and dk/dv
    kernels (``flash_attention.py:363-380``).  Saves (q, k, v, valid, out,
    lse)."""

    @staticmethod
    def forward(ctx, q, k, v, valid, n_heads: int, head_dim: int):
        out, lse = flash_forward(q, k, v, valid, n_heads, head_dim)
        ctx.save_for_backward(q, k, v, valid, out, lse)
        ctx.heads = (n_heads, head_dim)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, valid, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, valid, out, lse, dout, *ctx.heads)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, valid, n_heads: int, head_dim: int) -> torch.Tensor:
    """Packed causal attention with a gradient: (bs, L, D) x3 + (bs, L)
    int32 validity -> (bs, L, D)."""
    return FlashAttention.apply(q, k, v, valid, n_heads, head_dim)


flash_forward.launches = 0  # kernel launches in this process
flash_dq.launches = 0
flash_dkv.launches = 0
