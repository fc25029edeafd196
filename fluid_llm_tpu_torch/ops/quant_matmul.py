"""int8-weight matmul: ``x (..., K) @ dequant(q, scale) -> (..., N)``, reading int8.

Counterpart of ``fluid_llm_tpu/ops/quant_matmul.py``.  The kernels are in
``csrc/quant_matmul.cu`` (CUDA C++ for ``sm_90a``); they replace the TPU
kernels ``fluid_llm_tpu/ops/quant_matmul.py:_kernel_w8a8`` and ``:_kernel``
(w8a16), both reached through ``_qmm_2d``.  ``q`` is int8 ``(N, K)`` (the
``nn.Linear`` orientation), ``scale`` f32 ``(N,)`` per output channel, so
dequantisation commutes with the contraction:
``y[m, n] = (x @ q.T)[m, n] * scale[n]``.

- ``w8a8``: each row of x is quantised to int8 with its own absmax scale
  ``sx = absmax/127`` (1 where the row is zero), in f32 exactly as
  ``_quantize_act``; the int8 x int8 products sum in int32; then
  ``acc * sx * scale[n]`` in f32, cast to x's dtype, then the bias.
- ``w8a16``: ``(x @ q.T) * scale[n]`` with bf16 operands (the int8 -> bf16
  conversion is exact) and f32 sums, cast, then the bias.

On the card the JAX default (``FLUID_QMM=auto``: XLA's fused dequant
matmul, a choice measured on a TPU) has no counterpart: PyTorch has no
fused dequant matmul, so the plain route writes a bf16 copy of every weight
on every call.  Here the kernel is how int8 storage runs on the card;
:func:`int8_matmul_ref` (dequantise, then ``F.linear``; for w8a8 the
activation quantisation first) is its plain twin on the CPU and in the
tests.  The wrappers are forward only (serving): on CUDA they raise under
autograd.

Bound and design, in short (the source's header has the detail): at the
streaming step's 60 rows the call is bound by the weight bytes (2 x 60
operations a byte, far below the card's 295) and, at these sizes, by its
launch; at the exact rollout's 661 rows by the tensor cores.  One launch
per linear quantises the activation tile on its way into shared memory and
applies both scales in the epilogue; the output tile is 16 columns wide at
decode (48 blocks for N = 768) and 64 wide where 64 makes at least one
block per SM (the 661-row rollout, where it re-reads and re-quantises
the activation tile a quarter as often).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fluid_llm_tpu_torch.ops import _build
from fluid_llm_tpu_torch.ops.quant import QMM_MODES, dequantize_weight

K_TILE = 128  # the kernels' K step: K must be a multiple of it
N_TILE = 16  # the narrowest output tile: N must be a multiple of it


def supported(k: int, n: int) -> bool:
    """Weight shapes ``(N, K)`` the kernels take (``pick_blocks``'s gate):
    K a multiple of 128, N of 16.  Every linear of OPT-125m and of
    ``fluid/llama-125m`` qualifies; ``models.common.linear`` sends others
    through the dequantised weight."""
    return k > 0 and n > 0 and k % K_TILE == 0 and n % N_TILE == 0


def quantize_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic int8 quantisation (``quant_matmul.py:138-144``):
    (M, K) -> int8 (M, K) and the f32 (M, 1) scale.  The divisor 127 is a
    tensor on x's device (CUDA multiplies by the reciprocal of a Python
    scalar; the kernel divides)."""
    xf = x.float()
    ax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.where(ax > 0, ax / ax.new_full((), 127.0), 1.0)
    return torch.round(xf / sx).clamp(-127, 127).to(torch.int8), sx


def int8_matmul_ref(x, q, scale, bias=None, mode: str = "w8a8") -> torch.Tensor:
    """Plain PyTorch twin of both kernels: x (..., K), q int8 (N, K), scale
    (N,), bias (N,) or None -> (..., N) in x's dtype.

    w8a8: ``_quantize_act``, the integer sum (exact: float64 holds every
    int32 sum), then ``acc * sx * scale`` in f32 and the cast, as the JAX
    kernel path; w8a16: dequantise, then ``F.linear`` (the JAX package's
    XLA path, ``materialize_w``).  The bias is added after the cast, in
    x's dtype, as ``backbone._linear`` does."""
    if mode not in QMM_MODES:
        raise ValueError(f"int8_matmul: mode {mode!r}; one of {QMM_MODES}")
    lead, K = x.shape[:-1], x.shape[-1]
    if mode == "w8a8":
        xq, sx = quantize_act(x.reshape(-1, K))
        acc = xq.double() @ q.double().T
        y = (acc.float() * sx * scale.float()).to(x.dtype)
    else:
        y = F.linear(x.reshape(-1, K), dequantize_weight(q, scale, x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.reshape(*lead, q.shape[0])


def int8_matmul(x, q, scale, bias=None, mode: str = "w8a8") -> torch.Tensor:
    """``x (..., K) @ dequant(q (N, K), scale (N,)) + bias -> (..., N)``.

    CUDA tensors launch the ``mode`` kernel (:func:`qmm_w8a8` or
    :func:`qmm_w8a16`) or raise; CPU tensors take :func:`int8_matmul_ref`."""
    if mode not in QMM_MODES:
        raise ValueError(f"int8_matmul: mode {mode!r}; one of {QMM_MODES}")
    if x.device.type == "cpu":
        return int8_matmul_ref(x, q, scale, bias, mode)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    return (qmm_w8a8 if mode == "w8a8" else qmm_w8a16)(x, q, scale, bias)


def _launch(mode: str, x, q, scale, bias) -> torch.Tensor:
    name = f"quant_matmul_{mode}"
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, scale, bias)):
        raise RuntimeError(f"{name}: the int8 matmul kernel is forward only")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: bf16 activations only, got {x.dtype}")
    if q.dtype != torch.int8 or q.dim() != 2 or not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous int8 (N, K), got {q.dtype} "
                         f"{tuple(q.shape)}")
    N, K = q.shape
    if x.shape[-1] != K:
        raise ValueError(f"{name}: x {tuple(x.shape)} against q {tuple(q.shape)}")
    if not supported(K, N):
        raise ValueError(f"{name}: weight ({N}, {K}) not supported (K % {K_TILE}, N % {N_TILE})")
    for t, tname in ((scale, "scale"), (bias, "bias")):
        if t is not None and (t.dtype != torch.float32 or t.shape != (N,)
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: {tname} must be contiguous f32 ({N},)")
    for t, tname in ((q, "q"), (scale, "scale"), (bias, "bias")):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: {tname} on {t.device}, x on {x.device}")
    x2 = x.reshape(-1, K)
    if x2.stride(1) != 1 or x2.stride(0) % 8 or x2.data_ptr() % 16:
        x2 = x2.contiguous()  # the kernel reads rows in 16-byte vectors
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = getattr(_build.load(), name)(
            x2.data_ptr(), x2.stride(0), q.data_ptr(), scale.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(), M, N, K,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, name)
    return out.reshape(*x.shape[:-1], N)


def qmm_w8a8(x, q, scale, bias=None) -> torch.Tensor:
    """The w8a8 kernel on CUDA tensors (see the module docstring)."""
    out = _launch("w8a8", x, q, scale, bias)
    qmm_w8a8.launches += 1
    return out


def qmm_w8a16(x, q, scale, bias=None) -> torch.Tensor:
    """The w8a16 kernel on CUDA tensors (see the module docstring)."""
    out = _launch("w8a16", x, q, scale, bias)
    qmm_w8a16.launches += 1
    return out


qmm_w8a8.launches = 0  # kernel launches in this process
qmm_w8a16.launches = 0
