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

Bound and design, in short (the source's header has the detail).  w8a8:
at the streaming step's 60 rows the call is bound by the weight bytes (2 x
60 operations a byte, far below the card's 295) and, at these sizes, by
its launch and its chain of absmax, quantisation and K loop.  One launch
per linear: TMA streams the int8 weight tiles into a ring while the
consumer warpgroup takes each row's absmax over its K run and quantises x
once into an int8 tile in shared memory; ``wgmma`` multiplies the two int8
tiles into exact int32 sums, and the epilogue applies both scales.
:func:`w8a8_plan` picks the column tile and a K split across a
thread-block cluster (the ranks exchange their row maxima and sum their
int32 tiles in rank order, both exact) per shape.  w8a16: at the
exact rollout's 661 rows the tensor cores bound it, at 60 rows the weight
bytes and the chain of its K loop.  The kernel computes the transposed
product ``out^T = q x^T`` so that the int8 weight is ``wgmma``'s register
operand: TMA copies the weight as int8 and x as bf16 into a ring of
shared-memory stages on mbarriers, the consumer warpgroup converts its
weight fragment to bf16 in registers (a byte permute and one f32 subtract
per element, exact) and multiplies it with the x tile read from shared
memory; the next step's copies are in flight meanwhile.  :func:`plan`
picks the token tile and a K split across a thread-block cluster (reduced
in rank order, deterministic) per shape, read from the plans
``chip_smoke.py`` times at the main path's six shapes.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from fluid_llm_tpu_torch.ops import _build
from fluid_llm_tpu_torch.ops.quant import QMM_MODES, dequantize_weight

K_TILE = 128  # the kernels' K step: K must be a multiple of it
N_TILE = 16  # the narrowest output tile: N must be a multiple of it
W16_ROWS = 64  # w8a16: weight rows (output columns) of a block, wgmma's M
W16_K_STEP = 128  # w8a16: depth of a K step; a K split takes whole steps
W16_TOKEN_TILES = (64, 128, 136, 224)  # w8a16: token tiles (wgmma's N), narrowest first
MAX_K_SPLIT = 8  # blocks of a cluster, the portable limit
W8_ROWS = 64  # w8a8: token rows of a block, wgmma's M
W8_K_STEP = 128  # w8a8: depth of a K step; a K split takes runs of whole steps
W8_COL_TILES = (32, 64, 128, 256)  # w8a8: weight rows (output columns) of a block, wgmma's N


def supported(k: int, n: int) -> bool:
    """Weight shapes ``(N, K)`` the kernels take (``pick_blocks``'s gate):
    K a multiple of 128, N of 16.  Every linear of OPT-125m and of
    ``fluid/llama-125m`` qualifies; ``models.common.linear`` sends others
    through the dequantised weight."""
    return k > 0 and n > 0 and k % K_TILE == 0 and n % N_TILE == 0


def plans(M: int, K: int, N: int) -> list[tuple[int, int, int]]:
    """Every ``(blocks, token_tile, k_split)`` the w8a16 kernel takes for
    ``x (M, K) @ q (N, K)^T``: a token tile and a K split (a cluster of
    that many blocks, each a contiguous run of whole 128-deep K steps),
    with its grid of ``ceil(N / 64) x k_split x ceil(M / token_tile)``
    blocks."""
    steps = K // W16_K_STEP
    return [(-(-N // W16_ROWS) * k_split * -(-M // tile), tile, k_split)
            for tile in W16_TOKEN_TILES
            for k_split in range(1, MAX_K_SPLIT + 1) if steps % k_split == 0]


# The fastest plan at each of the main path's six shapes (OPT-125m's exact
# rollout, with bias) in the plan sweeps of chip_smoke.py (its "[plans]"
# lines, NVIDIA H100 80GB HBM3); at (60, 768, 768) (64, 1) comes within
# 3 %.  (661, 768, 3072) takes 5 token tiles of 136: 240 blocks, two an SM.
SWEPT_PLANS = {
    (661, 768, 768): (64, 1), (661, 768, 3072): (136, 1), (661, 3072, 768): (64, 1),
    (60, 768, 768): (64, 6), (60, 768, 3072): (64, 1), (60, 3072, 768): (64, 8),
}


def _grid_rule(every: list[tuple[int, int, int]], sms: int) -> tuple[int, int]:
    """``(tile, k_split)`` of the ``(blocks, tile, k_split)`` plans
    ``every``, as the sweeps ran: no K split where an unsplit grid within
    ``sms`` blocks fills a third of them (the largest such grid), else the
    largest grid within ``sms`` (a K split pays only where the unsplit
    grid leaves most SMs idle); where every unsplit grid passes ``sms``,
    the fewest blocks."""
    unsplit = [p for p in every if p[2] == 1]
    fits = [p for p in unsplit if p[0] <= sms]
    if not fits or max(fits)[0] * 3 < sms:
        fits = [p for p in every if p[0] <= sms]
    if fits:
        return max(fits, key=lambda p: (p[0], -p[1]))[1:]
    return min(unsplit, key=lambda p: (p[0], -p[1]))[1:]


@functools.lru_cache(maxsize=None)
def plan(M: int, K: int, N: int, sms: int = _build.H100_SMS) -> tuple[int, int]:
    """``(token_tile, k_split)`` of :func:`plans` for the w8a16 kernel: the
    sweep's fastest at the main path's six shapes (:data:`SWEPT_PLANS`),
    elsewhere :func:`_grid_rule`.  K a multiple of 128."""
    if (M, K, N) in SWEPT_PLANS and sms == _build.H100_SMS:
        return SWEPT_PLANS[M, K, N]
    return _grid_rule(plans(M, K, N), sms)


def w8a8_plans(M: int, K: int, N: int) -> list[tuple[int, int, int]]:
    """Every ``(blocks, n_tile, k_split)`` the w8a8 kernel takes for ``x (M,
    K) @ q (N, K)^T``: a column tile and a K split (a cluster of that many
    blocks; rank r multiplies 128-deep steps ``[r T / k_split, (r + 1) T /
    k_split)`` of ``T = K / 128``, at least one), with its grid of
    ``ceil(N / n_tile) x k_split x ceil(M / 64)`` blocks."""
    steps = K // W8_K_STEP
    return [(-(-N // tile) * k_split * -(-M // W8_ROWS), tile, k_split)
            for tile in W8_COL_TILES for k_split in range(1, min(MAX_K_SPLIT, steps) + 1)]


# The fastest w8a8 plan at chip_smoke.py phase 3's nine shapes (the
# flagship's 60- and 61-row streaming linears, OPT-125m's 661-row ones) in
# its plan sweep ("[plans] quant_matmul_w8a8" lines, NVIDIA H100 80GB HBM3)
W8A8_SWEPT_PLANS = {
    (60, 768, 768): (64, 6), (60, 768, 2048): (128, 6), (60, 2048, 768): (64, 8),
    (61, 768, 768): (64, 6), (61, 768, 2048): (128, 6), (61, 2048, 768): (64, 8),
    (661, 768, 768): (256, 3), (661, 768, 3072): (256, 1), (661, 3072, 768): (256, 3),
}


@functools.lru_cache(maxsize=None)
def w8a8_plan(M: int, K: int, N: int, sms: int = _build.H100_SMS) -> tuple[int, int]:
    """``(n_tile, k_split)`` of :func:`w8a8_plans`: the sweep's fastest at
    the swept shapes (:data:`W8A8_SWEPT_PLANS`), elsewhere
    :func:`_grid_rule`.  K a multiple of 128."""
    if (M, K, N) in W8A8_SWEPT_PLANS and sms == _build.H100_SMS:
        return W8A8_SWEPT_PLANS[M, K, N]
    return _grid_rule(w8a8_plans(M, K, N), sms)


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
    # the launch plan: w8a16's (token tile, K split), w8a8's (column tile, K split)
    extra = (plan if mode == "w8a16" else w8a8_plan)(M, K, N, _build.sm_count(x.device))
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = getattr(_build.load(), name)(
            x2.data_ptr(), x2.stride(0), q.data_ptr(), scale.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(), M, N, K, *extra,
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
