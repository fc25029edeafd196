"""Causal attention for short sequences (L <= 1536), packed layout: ``attn_impl="short"``.

Counterpart of ``fluid_llm_tpu/ops/short_attention.py``.  The kernel is
``csrc/short_attention.cu`` (CUDA C++ for ``sm_90a``); it replaces the TPU
kernel ``fluid_llm_tpu/ops/short_attention.py:_kernel`` (launched by
``_call``).  Its forward keeps the TPU kernel's arithmetic: f32 scores, an
exact softmax (row max, exp, sum, divide), p cast to bf16 before P·V, the
causal-and-valid mask with the diagonal forced on.

Bound and design, in short (the source's header has the detail): at the
training step's (8, 601, 768) the call is bound by its ~29.5 MB of bytes.
The TPU kernel kept a (128, L) f32 score tile and the whole K/V in VMEM,
which does not fit a Hopper block's 227 KB.  The kernel keeps no score
row: a block takes 64 or 128 query rows of one (batch, head) (one or two
consumer warpgroups, :func:`plan`), a producer warp copies 64-key K and V
tiles by TMA into a ring of shared-memory stages on mbarriers, and the
consumers make two passes with ``wgmma``: the row max and sum first, then
the scores again, ``p = bf16(exp(s - m) / l)`` in registers and ``P V``.

The backward recomputes through the plain twin, as the TPU package's
``custom_vjp`` (``short_attention.py:108-125``) differentiates its XLA
reference: :class:`ShortAttention` is the ``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fluid_llm_tpu_torch.ops import _build
from fluid_llm_tpu_torch.ops.exact_attention import causal_attention_ref, row_stride

MAX_TOKENS = 1536  # ``short_attention.py:32``
HEAD_DIMS = (64, 128)  # the kernel's templates; every preset's heads are 64 or 128 wide
QUERY_ROWS = (64, 128)  # query rows of a block: one or two consumer warpgroups


# The plain twin, the port of ``_xla_reference`` (``short_attention.py:92-105``):
# the same function as the exact-window kernel's twin (``_xla_packed``), in
# the packed layout.
short_attention_ref = causal_attention_ref


def supported(L: int, head_dim: int) -> bool:
    """Shapes the kernel takes: ``L <= 1536`` and ``head_dim % 64 == 0``, as
    ``short_attention.py:128-134`` asks (without its VMEM budget), here of
    the two head widths the kernel is built for."""
    return 1 <= L <= MAX_TOKENS and head_dim in HEAD_DIMS


def query_tiles(L: int, q_rows: int) -> list[range]:
    """The query rows of each block of one (batch, head), in launch order:
    the last tiles, which walk the most keys, first."""
    n = -(-L // q_rows)
    return [range(t * q_rows, min(L, (t + 1) * q_rows)) for t in reversed(range(n))]


@functools.lru_cache(maxsize=None)
def plan(bs: int, L: int, n_heads: int, head_dim: int, sms: int = _build.H100_SMS) -> int:
    """Query rows a block (64 or 128) for the kernel at this shape: 128
    (two warpgroups sharing each K/V tile) where that grid still fills
    ``sms`` blocks, else 64.  ``chip_smoke.py`` times both at the training
    step's and the rollout's shapes (``[plans]`` lines)."""
    wide = bs * n_heads * -(-L // QUERY_ROWS[1])
    return QUERY_ROWS[1] if wide >= sms else QUERY_ROWS[0]


def short_attention_fwd(q, k, v, valid, n_heads: int, head_dim: int) -> torch.Tensor:
    """(bs, L, D) x3 + (bs, L) int32 validity -> (bs, L, D).  CUDA tensors
    launch the kernel or raise (also under autograd: the gradient goes
    through :class:`ShortAttention`); CPU tensors take
    :func:`short_attention_ref`."""
    if q.device.type == "cpu":
        return short_attention_ref(q, k, v, valid, n_heads, head_dim)
    if q.device.type != "cuda":
        raise ValueError(f"short_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("short_attention_fwd: the kernel is forward only; under autograd "
                           "use ops.short_attention.short_attention")
    bs, L, D = q.shape
    if D != n_heads * head_dim or not supported(L, head_dim):
        raise ValueError(f"short_attention: L {L}, D {D}, heads {n_heads} x {head_dim} (L <= "
                         f"{MAX_TOKENS}, head_dim in {HEAD_DIMS})")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"short_attention: bf16 only, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (k.device == v.device == valid.device == q.device):
        raise ValueError("short_attention: all inputs must be on one device")
    if valid.dtype != torch.int32 or valid.shape != (bs, L) or not valid.is_contiguous():
        raise ValueError("short_attention: valid must be contiguous int32 (bs, L)")
    strides = [row_stride(t, n, bs, L, D) for t, n in ((q, "q"), (k, "k"), (v, "v"))]
    q_rows = plan(bs, L, n_heads, head_dim, _build.sm_count(q.device))
    out = torch.empty((bs, L, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _build.load().short_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(),
            bs, L, n_heads, head_dim, *strides, D, ctypes.c_float(head_dim ** -0.5), q_rows,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "short_attention_fwd")
    short_attention_fwd.launches += 1
    return out


short_attention_fwd.launches = 0  # kernel launches in this process


class ShortAttention(torch.autograd.Function):
    """The kernel's forward; the backward differentiates
    :func:`short_attention_ref` recomputed from the saved inputs (``_bwd``,
    ``short_attention.py:118-122``)."""

    @staticmethod
    def forward(ctx, q, k, v, valid, n_heads: int, head_dim: int):
        ctx.save_for_backward(q, k, v, valid)
        ctx.heads = (n_heads, head_dim)
        return short_attention_fwd(q, k, v, valid, n_heads, head_dim)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, valid = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = short_attention_ref(*qkv, valid, *ctx.heads)
            dq, dk, dv = torch.autograd.grad(out, qkv, dout)
        return dq, dk, dv, None, None, None


def short_attention(q, k, v, valid, n_heads: int, head_dim: int) -> torch.Tensor:
    """Packed causal attention with a gradient (the signature of the port's
    other ``attend`` functions): (bs, L, D) x3 + (bs, L) int32 validity ->
    (bs, L, D)."""
    return ShortAttention.apply(q, k, v, valid, n_heads, head_dim)
